"""Explicit Adam over named parameters (counterpart of
reduced_3dgs_tpu/trainer/optimizer.py:19-49).

The state is kept by parameter name, not in ``torch.optim.Adam``: the
densification events gather, scatter and concatenate it row by row with
the parameters, and ``load_numpy`` replaces the ``nn.Parameter`` objects,
so it must not be keyed by tensor identity. Hyperparameters are vanilla
3DGS's: betas (0.9, 0.999), eps 1e-15, with the JAX package's bias
correction arithmetic. The update is in place, under ``torch.no_grad()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class AdamState:
    count: int                          # steps taken
    m: Dict[str, torch.Tensor]          # first moments, by parameter name
    v: Dict[str, torch.Tensor]          # second moments, by parameter name


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(count=0,
                     m={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                        for k, p in params.items()},
                     v={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                        for k, p in params.items()})


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor], state: AdamState,
                lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> AdamState:
    """One Adam step on every parameter of ``params`` that has a ``.grad``,
    in place: p -= lr * m_hat / (sqrt(v_hat) + eps). A parameter without a
    gradient counts as a zero gradient, as in the JAX package. Returns
    ``state`` with its count advanced."""
    state.count += 1
    bc1 = 1.0 - b1 ** state.count
    bc2 = 1.0 - b2 ** state.count
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(lrs[name] * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return state

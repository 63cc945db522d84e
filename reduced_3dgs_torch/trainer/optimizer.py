"""Explicit Adam over named parameters (counterpart of
reduced_3dgs_tpu/trainer/optimizer.py:19-49).

The state is kept by parameter name, not in ``torch.optim.Adam``: the
densification events gather, scatter and concatenate it row by row with
the parameters, and ``load_numpy`` replaces the ``nn.Parameter`` objects,
so it must not be keyed by tensor identity. Hyperparameters are vanilla
3DGS's: betas (0.9, 0.999), eps 1e-15, with the JAX package's bias
correction arithmetic. The update is in place, under ``torch.no_grad()``.

The step count is a 0-d int32 tensor on the parameters' device, advanced in
place, and the bias corrections are computed from it there in float32, as
the JAX package computes them from its traced count: the update reads
nothing from the host, so a CUDA graph of a training step replays it with
the count it has reached.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class AdamState:
    count: torch.Tensor                 # steps taken, 0-d int32
    m: Dict[str, torch.Tensor]          # first moments, by parameter name
    v: Dict[str, torch.Tensor]          # second moments, by parameter name


def adam_count(n: int, device) -> torch.Tensor:
    """A step count of ``n`` as ``AdamState.count`` holds it."""
    return torch.tensor(n, dtype=torch.int32, device=device)


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    device = next(iter(params.values())).device
    return AdamState(count=adam_count(0, device),
                     m={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                        for k, p in params.items()},
                     v={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                        for k, p in params.items()})


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor], state: AdamState,
                lrs: Dict[str, object], b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> AdamState:
    """One Adam step on every parameter of ``params`` that has a ``.grad``,
    in place: p -= lr * m_hat / (sqrt(v_hat) + eps). A parameter without a
    gradient counts as a zero gradient, as in the JAX package. A learning
    rate is a float or a 0-d float32 tensor on the device. Returns
    ``state`` with its count advanced in place."""
    state.count.add_(1)
    t = state.count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(lrs[name] * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return state

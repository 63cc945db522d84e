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

``adam_update`` sends CPU tensors to ``adam_plain`` (PyTorch, the arithmetic
written out) and CUDA tensors to ``adam_fused``: one launch of
``ops/rasterize/csrc/adam.cu``'s kernel over every parameter of the state,
counted in ``adam_fused.launches`` (``ops/rasterize/launches``). There is no
fallback: a CUDA state the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from ..ops.rasterize._build import ADAM_MAX_TENSORS
from ..ops.rasterize.launches import counted, launch


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


def adam_update(params: Dict[str, torch.Tensor], state: AdamState,
                lrs: Dict[str, object], b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> AdamState:
    """One Adam step on every parameter of ``params``, in place: p -= lr *
    m_hat / (sqrt(v_hat) + eps). A parameter without a ``.grad`` counts as a
    zero gradient, as in the JAX package. A learning rate is a float or a 0-d
    float32 tensor on the device. Returns ``state`` with its count advanced in
    place. A state on the card takes ``adam_fused``, one on the CPU
    ``adam_plain``."""
    update = adam_fused if state.count.device.type == "cuda" else adam_plain
    return update(params, state, lrs, b1, b2, eps)


@torch.no_grad()
def adam_plain(params: Dict[str, torch.Tensor], state: AdamState, lrs: Dict[str, object],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> AdamState:
    """``adam_update`` in PyTorch on any device: the arithmetic the kernel
    repeats, parameter by parameter."""
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


def _check(name, p, state, lr, device):
    """Raise ValueError unless parameter ``name``'s p, gradient, moments and
    learning rate are what the kernel takes."""
    tensors = (("parameter", p), ("gradient", p.grad), ("first moment", state.m[name]),
               ("second moment", state.v[name]))
    for what, t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != device or t.shape != p.shape:
            raise ValueError(f"adam_fused: the {what} of {name} must be float32 {list(p.shape)} "
                             f"on {device}, got {t.dtype} {list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"adam_fused: the {what} of {name} is not contiguous")
    if isinstance(lr, torch.Tensor) and (lr.dim() != 0 or lr.dtype != torch.float32
                                         or lr.device != device):
        raise ValueError(f"adam_fused: the learning rate of {name} must be a float or a 0-d "
                         f"float32 tensor on {device}, got {lr.dtype} {list(lr.shape)} on "
                         f"{lr.device}")


@counted
@torch.no_grad()
def adam_fused(params: Dict[str, torch.Tensor], state: AdamState, lrs: Dict[str, object],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> AdamState:
    """``adam_plain`` on the card: the count advanced, then one launch of the
    kernel over every parameter, counted in ``adam_fused.launches``. CUDA
    tensors only; raises ValueError on what the kernel does not take, before
    anything changes."""
    device = state.count.device
    if state.count.dtype != torch.int32 or state.count.dim() != 0:
        raise ValueError(f"adam_fused: the count must be a 0-d int32 tensor, got "
                         f"{state.count.dtype} {list(state.count.shape)}")
    names = list(params)
    if not 0 < len(names) <= ADAM_MAX_TENSORS:
        raise ValueError(f"adam_fused: takes 1 to {ADAM_MAX_TENSORS} parameters, got "
                         f"{len(names)}")
    for name in names:
        _check(name, params[name], state, lrs[name], device)
    state.count.add_(1)
    arrays = [t.data_ptr() if t is not None else None
              for name in names for t in (params[name], params[name].grad, state.m[name],
                                          state.v[name])]
    lr_at = [lrs[n].data_ptr() if isinstance(lrs[n], torch.Tensor) else None for n in names]
    lr = [0.0 if isinstance(lrs[n], torch.Tensor) else float(lrs[n]) for n in names]
    launch(adam_fused, "adam_fused", device, len(names),
           (ctypes.c_longlong * len(names))(*(params[n].numel() for n in names)),
           (ctypes.c_void_p * len(arrays))(*arrays), (ctypes.c_void_p * len(names))(*lr_at),
           (ctypes.c_float * len(names))(*lr), state.count, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    return state

"""Row selection and appending over the trainer's per-Gaussian state
(counterpart of reduced_3dgs_tpu/trainer/functional.py:88-152, ``compact``
and ``scatter_append``).

The JAX engine keeps a padded capacity: it scatters appended rows into the
free slots after ``n_alive`` and compacts the kept rows to the front in
order. The port keeps exactly N rows, so compaction is plain selection and
an append is one concatenation per tensor: the kept rows, in their order,
then the new rows, and nothing after them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def keep_rows(trees: Dict[str, Dict[str, torch.Tensor]],
              keep: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every [N, ...] tensor of the groups in ``trees`` cut to the rows where
    ``keep`` [N] bool is True, in their order."""
    return {group: {k: v[keep] for k, v in tree.items()} for group, tree in trees.items()}


def append_rows(trees: Dict[str, Dict[str, torch.Tensor]], keep: Optional[torch.Tensor],
                new_params: Dict[str, torch.Tensor],
                new_aux: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``trees`` (the groups of ``BaseTrainer.state_trees``) cut to the rows
    where ``keep`` [N] bool is True (all rows when None), in their order,
    followed by M new rows, with one ``torch.cat`` per tensor: the
    parameters take ``new_params`` [M, ...], the aux state ``new_aux``
    [M, ...], and Adam's moments and the statistics zeros."""
    m = next(iter(new_params.values())).shape[0]

    def cat(v, new):
        return torch.cat([v if keep is None else v[keep], new.to(v.dtype)], dim=0)

    def zeros(v):
        return v.new_zeros((m,) + tuple(v.shape[1:]))

    out = {}
    for group, tree in trees.items():
        if group == "params":
            out[group] = {k: cat(v, new_params[k]) for k, v in tree.items()}
        elif group == "aux":
            out[group] = {k: cat(v, new_aux[k]) for k, v in tree.items()}
        else:
            out[group] = {k: cat(v, zeros(v)) for k, v in tree.items()}
    return out

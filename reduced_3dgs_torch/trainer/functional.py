"""Row selection over the trainer's per-Gaussian state (counterpart of
reduced_3dgs_tpu/trainer/functional.py:88-106, ``compact``).

The JAX engine keeps a padded capacity and compacts the kept rows to its
front in order. The port keeps exactly N rows, so compaction is plain
selection: the kept rows, in their order, and nothing after them.
"""
from __future__ import annotations

from typing import Dict

import torch


def keep_rows(trees: Dict[str, Dict[str, torch.Tensor]],
              keep: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every [N, ...] tensor of the groups in ``trees`` cut to the rows where
    ``keep`` [N] bool is True, in their order."""
    return {group: {k: v[keep] for k, v in tree.items()} for group, tree in trees.items()}

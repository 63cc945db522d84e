"""Device selection shared by the entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Return ``torch.device(device)``, raising when CUDA is asked for and absent.

    Entry points default to ``cuda``; they never fall back to the CPU on
    their own. Pass ``"cpu"`` explicitly to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev

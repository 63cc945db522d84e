"""Launch counts of the hand-written kernels' wrappers.

A wrapper registers with ``counted`` (it then holds ``.launches``, from 0)
and calls ``count_launch(wrapper)`` once per launch. A launch made while the
current stream captures a CUDA graph runs only when the graph is replayed:
it goes to ``captured_launches`` instead, and whoever replays the graph adds
what its capture recorded with ``add_replayed_launches``.
"""
from __future__ import annotations

import torch

# Launches recorded while a CUDA graph was being captured, by wrapper name.
captured_launches = {}
_wrappers = {}


def counted(wrapper):
    """Register ``wrapper``'s launch counts; returns it (a decorator)."""
    wrapper.launches = 0
    _wrappers[wrapper.__name__] = wrapper
    captured_launches[wrapper.__name__] = 0
    return wrapper


def wrappers() -> tuple:
    """The registered wrappers, in the order they registered."""
    return tuple(_wrappers.values())


def count_launch(wrapper):
    """Count one launch of ``wrapper`` (see the module docstring)."""
    if torch.cuda.is_current_stream_capturing():
        captured_launches[wrapper.__name__] += 1
    else:
        wrapper.launches += 1


def add_replayed_launches(tally: dict):
    """Count one replay of a graph whose capture recorded ``tally``
    (wrapper name -> launches) on each wrapper."""
    for name, n in tally.items():
        _wrappers[name].launches += n

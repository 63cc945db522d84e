"""The readings that set the sweep cell's limits: per seed, one run of the
cell (``drivers/sweep.py``) that prints the sound numbers of the program
against the reference, and, from the same records, the readings of the
control (the reference's sums in bfloat16, the precision below the
configuration's float32, and its rules in bfloat16) and of each fault of
``reference.importance.FAULTS`` (the first view left out of the sums, the
percentile at 0.2, the T_alpha_avg mask left out of the OR, v_pow at 0),
each put in the program's place and compared with the float32 reference
as the program is.

    python -m gpubench.sweep_control --seeds <n> [<n> ...] [--seconds <s>]

prints one JSON line per seed. It runs on the card (``--device cpu`` with
the tests' tiny overrides is for the tests).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from gpubench import correctness, program, run
from gpubench.drivers import sweep
from gpubench.reference import importance as ref_importance

WORKLOAD = "truck-flagship.sweep"
VARIANTS = ("bf16",) + ref_importance.FAULTS


def readings(cfg: dict, wl: dict, seed: int, seconds: float, device) -> dict:
    """One run's numbers, its verdict and each variant's numbers and
    verdict (on the event numbers' limits)."""
    wl = {**wl, "variants": list(VARIANTS)}
    ctx = SimpleNamespace(config=cfg, workload=wl, seed=int(seed), seconds=float(seconds),
                          trace=False, device=device, t_start=time.perf_counter())
    out = sweep.run(ctx)
    numbers = dict(out["numbers"])
    variants = numbers.pop("variants")
    correct, _ = correctness.verdict(numbers, wl["limits"])
    event_limits = {k: v for k, v in wl["limits"].items() if k in variants["bf16"]}
    return {"seed": seed, "correct": correct, "metrics": out["metrics"],
            "memory_peak_bytes": out["memory_peak_bytes"], "numbers": numbers,
            "variants": {v: {"fails": not correctness.verdict(n, event_limits)[0], **n}
                         for v, n in variants.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", required=True, type=int, nargs="+")
    parser.add_argument("--seconds", default=3.0, type=float)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    run.cache_environment()
    wl, cfg = run.cell(WORKLOAD)
    device = torch.device(args.device)
    for seed in args.seeds:
        print(json.dumps({"workload": WORKLOAD, **readings(cfg, wl, seed, args.seconds,
                                                           device)}), flush=True)
        program.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

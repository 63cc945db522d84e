"""One run of one benchmark cell of the PyTorch port (``reduced_3dgs_torch``).

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's file ``gpubench/workloads/<cell>.json``
names its configuration (``gpubench/configs/<config>.json``), its driver
(``gpubench/drivers/<driver>.py``), the driver's traffic parameters and the
limits of the numbers that decide ``correct``. The per-layer metrics of a
traced run are read by ``gpubench/metrics/<metric>.py``, or by the file
named by the part of the metric's name before its first dot. All of them
are found by name, so a new cell, configuration or metric is a new file.

The run builds its inputs on the card from ``--seed``, warms up (set-up),
measures for ``--seconds``, with ``--trace 1`` traces a further stretch,
checks what the timed path produced against the plain reference in
``gpubench/reference/``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit,
which also end standard error. Without a CUDA card, or with fewer cards
than the cell needs, it exits with 3 and prints no result; with JAX or the
JAX package loaded at the end, with 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reduced_3dgs_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> tuple:
    """(workload, config) of a cell, found by name."""
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    return workload, config


def metric_reader(name: str):
    """The ``read(record)`` of a per-layer metric: ``metrics/<name>.py``,
    else ``metrics/<name up to its first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"gpubench_metric_{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for the metric {name} under {HERE / 'metrics'}")


def cell_metrics(benchmark: dict, kind: str, name: str) -> list:
    """The entries of ``benchmark[kind]`` that the cell ``name`` reports."""
    return [m for m in benchmark[kind] if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_environment():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".gpubench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["R3DGS_COMPILE_CACHE"] = str(ROOT / "reduced_3dgs_torch" / "_build")
    os.environ["USE_FLAX"] = "0"


def execute(workload_name: str, seed: int, seconds: float, trace: bool, device: str,
            benchmark: dict = None, overrides: dict = None) -> dict:
    """A run without the look for a card: the result dict that ``main``
    prints. ``overrides`` = {"config": {...}, "workload": {...}} replaces
    keys of the cell's files (the tests run tiny cells so)."""
    import torch
    from gpubench import correctness
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    workload, config = cell(workload_name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    workload = {**workload, **overrides.get("workload", {})}
    driver = importlib.import_module(f"gpubench.drivers.{workload['driver']}")
    ctx = SimpleNamespace(config=config, workload=workload, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace),
                          device=torch.device(device), t_start=T_START)
    out = driver.run(ctx)
    correct, checks = correctness.verdict(out["numbers"], workload["limits"])
    dev = torch.device(device)
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    chips = next(w["chips"] for w in benchmark["workloads"] if w["name"] == workload_name)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if trace:
        record = out["record"]
        for m in cell_metrics(benchmark, "per_layer", workload_name):
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=record["busy_s"], window_s=record["window_s"])
    else:
        for m in cell_metrics(benchmark, "end_to_end", workload_name):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = out["record"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = parser.parse_args(argv)
    cache_environment()
    benchmark = load_json(ROOT / "BENCHMARK.json")
    entry = [w for w in benchmark["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry[0]["chips"]:
        print(f"{args.workload} needs {entry[0]['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                     benchmark)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

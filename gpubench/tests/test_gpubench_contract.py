"""BENCHMARK.json against the contract's shape and characters, and the
result line of every cell, untraced and traced, at a tiny size."""
import json
import re

import pytest

from conftest import CELLS, ROOT, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_budget(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert len(bench["command"]) <= 32 and all(1 <= len(w) <= 200 for w in bench["command"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[kind]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[kind]}) == len(bench[kind])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gpubench/")
        assert 1 <= len(c["source"]) <= 200


def test_metrics_cover_every_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        layer = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert m["moves"] in [r["name"] for r in reported]
        assert (ROOT / "gpubench" / "workloads" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        stem = ROOT / "gpubench" / "metrics"
        assert (stem / f"{m['name']}.py").is_file() or (stem / f"{m['name'].split('.')[0]}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(bench, cell, trace):
    result = json.loads(json.dumps(tiny_run(cell, trace)))
    keys = list(result)
    assert keys[-1] == "checks"
    assert sorted(keys) == sorted(RESULT_KEYS + (["breakdown"] if trace else []))
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in bench[kind]
               if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= set(allowed)
    if not trace:
        assert set(result["metrics"]) == set(allowed)
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}

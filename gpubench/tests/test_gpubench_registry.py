"""A new configuration, cell or per-layer metric is a new file, found by
its name with no edit of the harness."""
import json
import shutil

import pytest

from conftest import ROOT
from gpubench import run


@pytest.fixture
def tree(tmp_path, monkeypatch):
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "gpubench" / sub, tmp_path / sub)
    monkeypatch.setattr(run, "HERE", tmp_path)
    return tmp_path


def test_new_config_and_cell_found_by_name(tree):
    cfg = json.loads((tree / "configs" / "truck-flagship.json").read_text())
    cfg["n_gaussians"] = 7
    (tree / "configs" / "bicycle-flagship.json").write_text(json.dumps(cfg))
    wl = json.loads((tree / "workloads" / "truck-flagship.steady.json").read_text())
    wl["config"] = "bicycle-flagship"
    (tree / "workloads" / "bicycle-flagship.steady.json").write_text(json.dumps(wl))
    workload, config = run.cell("bicycle-flagship.steady")
    assert workload["config"] == "bicycle-flagship" and config["n_gaussians"] == 7


def test_new_metric_found_by_name(tree):
    (tree / "metrics" / "capture_ms.py").write_text(
        "def read(record):\n    return sum(record['spans'].get('capture', [0.0])) * 1e3\n")
    (tree / "metrics" / "peak.densify.py").write_text("def read(record):\n    return 42.0\n")
    record = {"spans": {"capture": [0.25, 0.5]}}
    assert run.metric_reader("capture_ms.densify")(record) == 750.0
    assert run.metric_reader("peak.densify")(record) == 42.0
    with pytest.raises(FileNotFoundError):
        run.metric_reader("nothing.here")


def test_metrics_of_a_cell_by_its_workloads_key():
    bench = {"per_layer": [{"name": "a", "workloads": ["x"]}, {"name": "b"},
                           {"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in run.cell_metrics(bench, "per_layer", "x")] == ["a", "b"]

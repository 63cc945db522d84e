"""A run that finds no CUDA card fails and prints no result; so does a
checkout that holds only BENCHMARK.json and the benchmark's folder."""
import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["-m", "gpubench.run", "--workload", "truck-flagship.steady", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def run_in(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = run_in(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_in(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""

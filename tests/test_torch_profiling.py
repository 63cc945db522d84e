"""The port's profiling helpers (utils/profiling.py) and build cache
(utils/cache.py), the counterparts of the JAX package's trace, time_fn,
annotate and enable_compile_cache.

  * ``trace`` writes a Chrome trace on the CPU holding an ``annotate``d
    region; ``time_fn`` returns JAX's {"mean_s", "iters"} and calls the
    function warmup + iters times.
  * ``enable_compile_cache`` moves the build directory (argument, then
    ``R3DGS_COMPILE_CACHE``), leaves it alone with neither, and restores it
    from what it returns; the native library then builds there.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.models import native_io  # noqa: E402
from reduced_3dgs_torch.ops.rasterize import _build  # noqa: E402
from reduced_3dgs_torch.utils import cache, profiling  # noqa: E402
from reduced_3dgs_tpu.utils import profiling as jprofiling  # noqa: E402


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir) as where:
        with profiling.annotate("r3dgs_region"):
            (x @ x).sum()
    assert where == log_dir
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "r3dgs_region" for e in events)


def test_time_fn_matches_the_jax_contract():
    calls = []
    out = profiling.time_fn(lambda a, b=0: calls.append(a + b), 1, b=2, iters=4, warmup=3)
    assert set(out) == {"mean_s", "iters"} == set(jprofiling.time_fn(lambda: 0, iters=2))
    assert out["iters"] == 4 and out["mean_s"] >= 0 and calls == [3] * 7


def test_enable_compile_cache_moves_and_restores(tmp_path, monkeypatch):
    monkeypatch.delenv("R3DGS_COMPILE_CACHE", raising=False)
    start = _build.BUILD_DIR
    assert start == cache.DEFAULT_BUILD_DIR
    assert start.endswith(os.path.join("reduced_3dgs_torch", "_build"))
    try:
        assert cache.enable_compile_cache() == start and _build.BUILD_DIR == start
        assert cache.enable_compile_cache(str(tmp_path / "a")) == start
        assert _build.BUILD_DIR == str(tmp_path / "a")
        assert _build._library_path("composite_fwd").startswith(str(tmp_path / "a"))
        assert native_io.library_path().startswith(str(tmp_path / "a"))
        monkeypatch.setenv("R3DGS_COMPILE_CACHE", str(tmp_path / "b"))
        assert cache.enable_compile_cache() == str(tmp_path / "a")
        assert _build.BUILD_DIR == str(tmp_path / "b")
    finally:
        cache.enable_compile_cache(start)
    assert _build.BUILD_DIR == start

"""The PyTorch port stands alone: no JAX (and no tqdm, which the GPU
machine lacks) at import time, no quiet CPU fallback, no kernel launch for
CPU tensors."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every module of the port with jax, flax, tqdm, the JAX
    package and the JAX side's tools blocked; none of them may be needed or
    end up loaded."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "tqdm", "reduced_3dgs_tpu", "tools")
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked import of " + name)
                return None

        sys.meta_path.insert(0, Block())
        import reduced_3dgs_torch
        names = [m.name for m in pkgutil.walk_packages(
            reduced_3dgs_torch.__path__, "reduced_3dgs_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        for name in ("reduced_3dgs_torch.train", "reduced_3dgs_torch.trainer.base",
                     "reduced_3dgs_torch.trainer.optimizer",
                     "reduced_3dgs_torch.utils.schedule",
                     "reduced_3dgs_torch.trainer.functional",
                     "reduced_3dgs_torch.trainer.densifier.abc",
                     "reduced_3dgs_torch.importance.trainer",
                     "reduced_3dgs_torch.shculling.trainer",
                     "reduced_3dgs_torch.ops.shculling_stats",
                     "reduced_3dgs_torch.ops.knn", "reduced_3dgs_torch.ops.redundancy",
                     "reduced_3dgs_torch.pruning.trainer",
                     "reduced_3dgs_torch.pruning.combinations",
                     "reduced_3dgs_torch.combinations", "reduced_3dgs_torch.ops.kmeans",
                     "reduced_3dgs_torch.quantization.abc",
                     "reduced_3dgs_torch.quantization.quantizer",
                     "reduced_3dgs_torch.quantization.exclude_zeros",
                     "reduced_3dgs_torch.quantization.wrapper", "reduced_3dgs_torch.quantize",
                     "reduced_3dgs_torch.prepare", "reduced_3dgs_torch.trainer.checkpoint",
                     "reduced_3dgs_torch.trainer.camera_trainer",
                     "reduced_3dgs_torch.models.packed_sh", "reduced_3dgs_torch.utils.debug",
                     "reduced_3dgs_torch.ops.rasterize.twodgs", "reduced_3dgs_torch.metrics",
                     "reduced_3dgs_torch.metrics.lpips", "reduced_3dgs_torch.viewer",
                     "reduced_3dgs_torch.models.native_io",
                     "reduced_3dgs_torch.utils.profiling", "reduced_3dgs_torch.utils.cache",
                     "reduced_3dgs_torch.parallel", "reduced_3dgs_torch.parallel.sharding",
                     "reduced_3dgs_torch.parallel.stats", "reduced_3dgs_torch.tools",
                     "reduced_3dgs_torch.tools.convergence_proof"):
            assert name in names, name
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 71  # every module was imported


def test_render_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    from reduced_3dgs_torch.render import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["-s", str(tmp_path), "-d", str(tmp_path)])


def test_composite_fwd_cpu_uses_plain_version():
    from reduced_3dgs_torch.ops.rasterize import composite
    e = torch.zeros((10, 3))
    e[2] = e[4] = 1.0  # unit conic
    e[5] = 0.5         # opacity
    e[0] = e[1] = 3.0  # centred on pixel (3, 3) of tile 0
    rs = torch.tensor([0, 3], dtype=torch.int32)
    re = torch.tensor([3, 3], dtype=torch.int32)
    before = composite.composite_fwd.launches
    out = composite.composite_fwd(e, rs, re, tiles_x=2)
    plain = composite.composite_fwd_plain(e, rs, re, tiles_x=2)
    assert composite.composite_fwd.launches == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[1][0, 3 * 16 + 3, 0] == pytest.approx(0.125)  # three blends of 0.5
    assert out[1][1].eq(1).all() and out[0][1].eq(0).all()    # empty tile


def test_composite_fwd_rejects_other_devices_and_bad_inputs():
    from reduced_3dgs_torch.ops.rasterize import composite
    rs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        composite.composite_fwd(torch.zeros((10, 4), device="meta"), rs.to("meta"),
                                rs.to("meta"), 1)
    with pytest.raises(ValueError, match="float32"):
        composite.composite_fwd(torch.zeros((9, 4)), rs, rs, 1)
    with pytest.raises(ValueError, match="int32"):
        composite.composite_fwd(torch.zeros((10, 4)), rs.long(), rs, 1)


def test_composite_fwd_stats_cpu_uses_plain_version():
    """The statistics compositor on CPU tensors runs its plain version and
    launches no kernel, neither its own nor the forward compositor's."""
    from reduced_3dgs_torch.ops.rasterize import composite
    e = torch.zeros((10, 3))
    e[2] = e[4] = 1.0
    e[5] = 0.5
    e[0] = e[1] = 3.0
    rs = torch.tensor([0, 3], dtype=torch.int32)
    re = torch.tensor([3, 3], dtype=torch.int32)
    before = (composite.composite_fwd_stats.launches, composite.composite_fwd.launches)
    out = composite.composite_fwd_stats(e, rs, re, tiles_x=2)
    plain = composite.composite_fwd_stats_plain(e, rs, re, tiles_x=2)
    assert (composite.composite_fwd_stats.launches, composite.composite_fwd.launches) == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    stats = out[3]
    assert stats.shape == (4, 3)
    # Three equal entries: every pixel one blends into, the next two do too
    # (T stays far above 1e-4), so the counts agree; at pixel (3, 3) the
    # incoming T is 1, 0.5 and 0.25.
    assert stats[0, 0] == stats[0, 1] == stats[0, 2] > 0
    assert torch.equal(stats[1], stats[0] * 0.5)
    assert (stats[3, 0] > stats[3, 1] > stats[3, 2]).item()
    with pytest.raises(ValueError, match="cpu or cuda"):
        composite.composite_fwd_stats(e.to("meta"), rs.to("meta"), re.to("meta"), 2)


def test_composite_bwd_cpu_uses_plain_version():
    from reduced_3dgs_torch.ops.rasterize import composite
    e = torch.zeros((10, 3))
    e[2] = e[4] = 1.0
    e[5] = 0.5
    e[0] = e[1] = 3.0
    e[6] = 1.0
    rs = torch.tensor([0, 3], dtype=torch.int32)
    re = torch.tensor([3, 3], dtype=torch.int32)
    _, final_t, latch = composite.composite_fwd(e, rs, re, tiles_x=2)
    g_c = torch.ones((2, 256, 4))
    g_t = torch.ones((2, 256, 1))
    before = composite.composite_bwd.launches
    out = composite.composite_bwd(e, rs, re, 2, final_t, latch, g_c, g_t)
    plain = composite.composite_bwd_plain(e, rs, re, 2, final_t, latch, g_c, g_t)
    assert composite.composite_bwd.launches == before
    assert torch.equal(out, plain) and out.shape == (10, 3)
    assert out[6].gt(0).all()  # red gradient: the blend weights


def test_composite_bwd_rejects_other_devices_and_bad_inputs():
    from reduced_3dgs_torch.ops.rasterize import composite
    rs = torch.zeros(1, dtype=torch.int32)
    ft, g4 = torch.ones((1, 256, 1)), torch.ones((1, 256, 4))
    lat = torch.zeros((1, 256, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        composite.composite_bwd(torch.zeros((10, 4), device="meta"), rs.to("meta"),
                                rs.to("meta"), 1, ft.to("meta"), lat.to("meta"),
                                g4.to("meta"), ft.to("meta"))
    with pytest.raises(ValueError, match="g_color4"):
        composite.composite_bwd(torch.zeros((10, 4)), rs, rs, 1, ft, lat, ft, ft)
    with pytest.raises(ValueError, match="latch"):
        composite.composite_bwd(torch.zeros((10, 4)), rs, rs, 1, ft, lat.float(), g4, ft)


def test_training_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    """training() without a device asks for CUDA and raises when it is
    absent; asked for the CPU, it refuses a model that lies elsewhere."""
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.train import training
    model = VariableSHGaussianModel(3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training([], model, None, None, str(tmp_path), iteration=1, save_iterations=[])
    with pytest.raises(ValueError, match="model lies on"):
        training([], VariableSHGaussianModel(3, device="meta"), None, None, str(tmp_path),
                 iteration=1, save_iterations=[], device="cpu")

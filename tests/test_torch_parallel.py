"""PyTorch port vs JAX package: the band viewport of both renderers and the
single-process parts of ``parallel/`` (no process is spawned here; the
multi-process mesh is tests/test_torch_sharded.py).

  * ``render_band`` of the 3DGS model and of the 2DGS model against the JAX
    models' ``render_band`` (XLA path) at tile row offsets {0, 1, 2} and
    band heights {1, 2, 3} tile rows, the last band reaching below the image:
    image and final_T atol 1e-4, depth atol 5e-4 (JAX
    tests/test_pallas_kernel.py:27-32), radii and entry counts exact, on the
    scenes whose full renders tests/test_torch_render.py and
    tests/test_torch_twodgs.py hold to the same bars.
  * The bands of 1-4 tile ranks stitched equal the port's full render
    within 1e-5 (JAX tests/test_parallel.py:20-32), their entry counts sum
    to the full count, and their ``with_stats`` counts to the full counts,
    exactly.
  * ``band_layout`` equals JAX's; ``distributed_init`` does nothing without
    WORLD_SIZE (JAX :93); ``make_mesh`` on a world of one; a short camera
    batch wraps; a ShardedTrainer on a 1x1 mesh steps as the Trainer does.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reduced_3dgs_torch import parallel as tparallel  # noqa: E402
from reduced_3dgs_torch.dataset.camera import build_camera as tbuild_camera  # noqa: E402
from reduced_3dgs_torch.parallel import sharding as tsharding  # noqa: E402
from reduced_3dgs_torch.shculling import VariableSHGsplat2DGSGaussianModel as T2DGS  # noqa: E402
from reduced_3dgs_torch.trainer import Trainer  # noqa: E402
from reduced_3dgs_tpu import parallel as jparallel  # noqa: E402
from reduced_3dgs_tpu.dataset.camera import build_camera as jbuild_camera  # noqa: E402
from reduced_3dgs_tpu.parallel import sharding as jsharding  # noqa: E402
from reduced_3dgs_tpu.shculling import VariableSHGsplat2DGSGaussianModel as J2DGS  # noqa: E402

from .test_torch_fixtures import (jax_model, random_cloud_np, rotation_y,  # noqa: E402
                                  torch_dataset, torch_model, views_np)

BG = (0.2, 0.4, 0.6)
ATOL = {"render": 1e-4, "final_T": 1e-4, "depth": 5e-4}
TILES_Y = 3


def _cameras(h, w):
    kw = dict(image_height=h, image_width=w, FoVx=math.radians(60),
              FoVy=2 * math.atan(math.tan(math.radians(30)) * h / w),
              R=rotation_y(0.15), T=np.array([0.1, -0.05, 0.2], np.float32), bg_color=BG)
    return jbuild_camera(**kw), tbuild_camera(**kw, device="cpu")


def _surfels(params):
    """The 2DGS test's flat cloud: the third scale collapsed."""
    params = dict(params, scaling=params["scaling"].copy())
    params["scaling"][:, 2] = -10.0
    return params


@pytest.fixture(scope="module")
def models():
    """{family: (JAX model, port model, JAX camera, port camera)}: the 3DGS
    render test's scene at 48x80 and the 2DGS render test's flat cloud at
    48x48."""
    params, degrees = random_cloud_np(41, 70, spread=0.8)
    flat, flat_degrees = random_cloud_np(3, 64, scale_lo=-3.0, scale_hi=-1.8)
    flat = _surfels(flat)
    j2 = J2DGS(3)
    j2.set_parameters({k: jnp.asarray(v) for k, v in flat.items()})
    j2.aux_set({"degrees": jnp.asarray(flat_degrees)})
    return {"3dgs": (jax_model(params, degrees), torch_model(params, degrees),
                     *_cameras(48, 80)),
            "2dgs": (j2, T2DGS(3, device="cpu").load_numpy(flat, flat_degrees),
                     *_cameras(48, 48))}


_JAX_BANDS = {}


def _jax_band(family, jm, jcam, tile_rows):
    """The JAX model's render_band (XLA path) of ``tile_rows`` tile rows,
    jitted once per family and height, the offset traced."""
    key = (family, tile_rows)
    if key not in _JAX_BANDS:
        settings = jm.render_settings(jcam)
        tiles_x = -(-jcam.image_width // 16)
        _JAX_BANDS[key] = jax.jit(lambda params, aux, offset: jm.render_band(
            params, settings, aux=aux, tile_row_offset=offset, tile_rows=tile_rows,
            key_buffer_size=70 * tiles_x * tile_rows, use_pallas=False))
    return _JAX_BANDS[key]


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
@pytest.mark.parametrize("tile_rows", [1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_band_matches_jax(models, family, tile_rows, offset):
    jm, tm, jcam, tcam = models[family]
    with torch.no_grad():
        t = tm.render_band(tcam, offset, tile_rows)
    j = _jax_band(family, jm, jcam, tile_rows)(jm.parameters(), jm.aux_state(), offset)
    assert t["render"].shape == (3, 16 * tile_rows, tcam.image_width)
    assert t["num_rendered"] == int(j["num_rendered"])
    for key, atol in ATOL.items():
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), rtol=0, atol=atol,
                                   err_msg=key)
    np.testing.assert_array_equal(t["radii"].numpy(), np.asarray(j["radii"]))
    if offset + tile_rows > TILES_Y:   # the rows below the image are empty
        below = 16 * (TILES_Y - offset)
        assert float(t["final_T"][below:].min()) == 1.0


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
@pytest.mark.parametrize("n_tile", [1, 2, 3, 4])
def test_bands_stitch_to_the_full_render(models, family, n_tile):
    _, tm, _, tcam = models[family]
    band_tiles, band_h, padded_h = tparallel.sharding.band_layout(tcam.image_height, n_tile)
    with torch.no_grad():
        full = tm.render(tcam)
        full_stats = tm.render(tcam, with_stats=True)
        bands = [tm.render_band(tcam, r * band_tiles, band_tiles) for r in range(n_tile)]
        stats = [tm.render_band(tcam, r * band_tiles, band_tiles, with_stats=True)
                 for r in range(n_tile)]
    h = tcam.image_height
    for key, dim in (("render", 1), ("final_T", 0), ("depth", 0)):
        stitched = torch.cat([b[key] for b in bands], dim=dim).narrow(dim, 0, h)
        assert torch.cat([b[key] for b in bands], dim=dim).shape[dim] == padded_h
        np.testing.assert_allclose(stitched.numpy(), full[key].numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert sum(b["num_rendered"] for b in bands) == full["num_rendered"]
    for key in ("gaussians_count", "touched_pixels"):
        assert torch.equal(sum(s[key] for s in stats), full_stats[key]), key
    for key in ("opacity_important_score", "T_alpha_important_score", "transmittance_sum"):
        np.testing.assert_allclose(sum(s[key] for s in stats).numpy(), full_stats[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("height", [31, 32, 48, 544])
@pytest.mark.parametrize("n_tile", [1, 2, 3, 4])
def test_band_layout_matches_jax(height, n_tile):
    assert tsharding.band_layout(height, n_tile) == jsharding.band_layout(height, n_tile)


def test_distributed_init_noop_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tparallel.distributed_init("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tparallel.distributed_init("cpu") is False
    assert tsharding.rank_device("cpu") == torch.device("cpu")
    assert tsharding.is_main_rank()


def test_make_mesh_on_a_world_of_one():
    mesh = tparallel.make_mesh()
    assert mesh.shape == {"data": 1, "tile": 1}
    assert (mesh.size, mesh.rank, mesh.data_rank, mesh.tile_rank) == (1, 0, 0, 0)
    x = torch.arange(3.0)
    assert mesh.all_reduce([x], "tile")[0] is x      # axes of size 1: no collective
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tparallel.make_mesh(n_data=1, n_tile=2)
    # The JAX mesh on its 8 CPU devices has the same named axes.
    assert set(jparallel.make_mesh(n_data=2, n_tile=4).shape) == set(mesh.shape)


def test_batch_cameras_wraps_a_short_batch():
    assert tsharding.batch_cameras(["a"], 3) == (["a", "a", "a"], 1)
    assert tsharding.batch_cameras(["a", "b"], 3) == (["a", "b", "a"], 2)
    assert tsharding.batch_cameras("a", 2) == (["a", "a"], 1)
    with pytest.raises(ValueError):
        tsharding.batch_cameras(["a", "b", "c"], 2)


def test_one_by_one_mesh_steps_as_the_trainer():
    """On a world of one the sharded trainer renders one band covering the
    image, and its steps (losses, parameters, statistics) are the
    Trainer's."""
    params, degrees = random_cloud_np(5, 30)
    cams = views_np(2, 32, 32)
    images = [torch.from_numpy(np.random.default_rng(i).uniform(0, 1, (3, 32, 32))
                               .astype(np.float32)) for i in range(2)]
    ma, mb = torch_model(params, degrees), torch_model(params, degrees)
    da, db = torch_dataset(cams, images), torch_dataset(cams, images)
    a, b = Trainer(ma, da), tparallel.ShardedTrainer(mb, db)
    for i in range(4):
        la, oa = a.step(da[i % 2])
        lb, ob = b.step([db[i % 2]])
        np.testing.assert_allclose(float(lb), float(la), rtol=1e-6)
        assert torch.equal(oa["render"], ob["render"])
    for k, p in ma.param_dict().items():
        np.testing.assert_allclose(mb.param_dict()[k].detach().numpy(), p.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert torch.equal(a.xyz_grad_denom, b.xyz_grad_denom)
    assert torch.equal(a.max_radii2d, b.max_radii2d)
    np.testing.assert_allclose(b.xyz_grad_accum.numpy(), a.xyz_grad_accum.numpy(), rtol=1e-6)

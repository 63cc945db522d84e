"""PyTorch port vs JAX package: projection and SH math, elementwise."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reduced_3dgs_torch.ops import projection as tproj  # noqa: E402
from reduced_3dgs_torch.ops import sh as tsh  # noqa: E402
from reduced_3dgs_tpu.ops import projection as jproj  # noqa: E402
from reduced_3dgs_tpu.ops import sh as jsh  # noqa: E402

from .test_torch_fixtures import rotation_y  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.normal(0, 0.5, (n, 4)).astype(np.float32) + np.array([1, 0, 0, 0], np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _view():
    R = rotation_y(0.3)
    T = np.array([0.2, -0.1, 0.5], np.float32)
    return R, T


def test_quat_to_rotmat():
    q = _quats(np.random.default_rng(0), 50)
    _close(tproj.quat_to_rotmat(torch.from_numpy(q)), jproj.quat_to_rotmat(jnp.asarray(q)))


def test_build_cov3d():
    rng = np.random.default_rng(1)
    q = _quats(rng, 50)
    s = np.exp(rng.uniform(-4, -1, (50, 3))).astype(np.float32)
    _close(tproj.build_cov3d(torch.from_numpy(s), 0.7, torch.from_numpy(q)),
           jproj.build_cov3d(jnp.asarray(s), 0.7, jnp.asarray(q)))


def test_build_cov2d_with_fov_clamp():
    """Some points lie far outside the 1.3 tan(fov) frustum clamp, and one
    row is culled (valid False) with view z 0."""
    rng = np.random.default_rng(2)
    n = 60
    means = np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(0.5, 5, (n, 1))],
                           axis=1).astype(np.float32)
    R, T = _view()
    means[0] = -T @ R.T  # view-space origin
    s = np.exp(rng.uniform(-3, -1, (n, 3))).astype(np.float32)
    q = _quats(rng, n)
    valid = np.ones(n, bool)
    valid[0] = False
    jv = jproj.world_view_transform_from_rt(jnp.asarray(R), jnp.asarray(T))
    tv = tproj.world_view_transform_from_rt(torch.from_numpy(R), torch.from_numpy(T))
    tanx, tany = math.tan(0.5), math.tan(0.4)
    fx, fy = jproj.focals_from_fov(64, 48, tanx, tany)
    jc = jproj.build_cov2d(jnp.asarray(means), jproj.build_cov3d(jnp.asarray(s), 1.0, jnp.asarray(q)),
                           jv, fx, fy, tanx, tany, valid=jnp.asarray(valid))
    tc = tproj.build_cov2d(torch.from_numpy(means),
                           tproj.build_cov3d(torch.from_numpy(s), 1.0, torch.from_numpy(q)),
                           tv, fx, fy, tanx, tany,
                           valid=torch.from_numpy(valid))
    t_view = np.asarray(jproj.world_to_view(jnp.asarray(means), jv))[1:]
    assert (np.abs(t_view[:, 0] / t_view[:, 2]) > 1.3 * tanx).sum() >= 5
    _close(tc, jc, rtol=1e-5, atol=1e-4)


def test_invert_cov2d_and_lambda_max():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.3, 50, 40)
    c = rng.uniform(0.3, 50, 40)
    b = rng.uniform(-1, 1, 40) * np.sqrt(a * c) * 0.9
    cov = np.stack([a, b, c], -1).astype(np.float32)
    cov[0] = [1.0, 1.0, 1.0]  # det == 0
    jc, jd = jproj.invert_cov2d(jnp.asarray(cov))
    tc, td = tproj.invert_cov2d(torch.from_numpy(cov))
    _close(tc, jc)
    _close(td, jd, atol=1e-4)
    assert float(tc[0].abs().sum()) == 0.0
    _close(tproj.cov2d_lambda_max(torch.from_numpy(cov), td),
           jproj.cov2d_lambda_max(jnp.asarray(cov), jd))


@pytest.mark.parametrize("per_axis", [False, True])
def test_tile_rect(per_axis):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-40, 120, (80, 2)).astype(np.float32)
    rad = rng.uniform(0, 30, (80, 2) if per_axis else (80,)).astype(np.float32)
    jmin, jmax = jproj.tile_rect(jnp.asarray(pts), jnp.asarray(rad), 5, 3)
    tmin, tmax = tproj.tile_rect(torch.from_numpy(pts), torch.from_numpy(rad), 5, 3)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    assert tmin.dtype == torch.int32 and tmax.dtype == torch.int32


def test_projection_and_view_matrices():
    R, T = _view()
    _close(tproj.build_projection_matrix(0.01, 100.0, 1.1, 0.8),
           jproj.build_projection_matrix(0.01, 100.0, 1.1, 0.8))
    jv = jproj.world_view_transform_from_rt(jnp.asarray(R), jnp.asarray(T))
    tv = tproj.world_view_transform_from_rt(torch.from_numpy(R), torch.from_numpy(T))
    _close(tv, jv)
    _close(tproj.camera_center_from_world_view(tv), jproj.camera_center_from_world_view(jv))
    pts = np.random.default_rng(5).normal(0, 2, (30, 3)).astype(np.float32)
    full = jv @ jproj.build_projection_matrix(0.01, 100.0, 1.1, 0.8)
    tfull = tv @ tproj.build_projection_matrix(0.01, 100.0, 1.1, 0.8)
    _close(tproj.project_points(torch.from_numpy(pts), tfull),
           jproj.project_points(jnp.asarray(pts), full), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(6 + degree)
    shs = rng.normal(0, 0.5, (64, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    jd = jsh.normalize_dirs(jnp.asarray(dirs))
    td = tsh.normalize_dirs(torch.from_numpy(dirs))
    _close(td, jd)
    _close(tsh.sh_basis(td, degree), jsh.sh_basis(jd, degree))
    _close(tsh.eval_sh(torch.from_numpy(shs), td, degree),
           jsh.eval_sh(jnp.asarray(shs), jd, degree))


def test_eval_sh_clamp_gradient_at_zero_matches_jax():
    """Degree 0 with the DC coefficient baked from a black mean colour,
    (0 - 0.5) / SH_C0 in float32, as the SH cull writes it: the colour is
    exactly 0, where the clamp passes half of the gradient in both
    packages."""
    import jax
    black = np.float32(-0.5) / np.float32(jsh.SH_C0)
    dc = np.array([[[black, 0.3, -4.0]]], np.float32)
    dirs = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = torch.from_numpy(dc).requires_grad_(True)
    tsh.eval_sh(t, torch.from_numpy(dirs), 0).sum().backward()
    j = jax.grad(lambda s: jsh.eval_sh(s, jnp.asarray(dirs), 0).sum())(jnp.asarray(dc))
    assert float(tsh.eval_sh(torch.from_numpy(dc), torch.from_numpy(dirs), 0)[0, 0]) == 0.0
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(j))
    c0 = float(np.float32(jsh.SH_C0))
    assert t.grad[0, 0].tolist() == [0.5 * c0, c0, 0.0]


def test_degree_coeff_mask():
    deg = np.array([0, 1, 2, 3, 3, 0, 2], np.int32)
    np.testing.assert_array_equal(tsh.degree_coeff_mask(torch.from_numpy(deg)).numpy(),
                                  np.asarray(jsh.degree_coeff_mask(jnp.asarray(deg))))

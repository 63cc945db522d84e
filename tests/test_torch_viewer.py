"""The port's viewer (viewer.py) against the JAX package's.

  * ``_orbit_camera`` gives JAX's matrices and camera centre (also at the
    poles, where the right axis falls back to x).
  * ``render_frame`` returns a PNG of the viewport's size, different views
    differ, and the scale and SH overrides are restored; it decodes to the
    uint8 of the model's render from the orbit camera, and stamps the
    frame's render and encode times.
  * A frame equals the JAX viewer's frame of the same model within 1 LSB.
  * The HTTP surface: the page, /render with its headers, 404.
  * ``load_model`` honours ``--backend`` (gsplat-2dgs views surfels), and
    ``main`` asks for CUDA by default.
"""
import argparse
import io
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from reduced_3dgs_torch import viewer as tviewer  # noqa: E402
from reduced_3dgs_tpu import viewer as jviewer  # noqa: E402

from .test_torch_fixtures import jax_model, random_cloud_np, torch_model  # noqa: E402

H, W = 48, 64
PNG = b"\x89PNG\r\n\x1a\n"


def scene():
    params, degrees = random_cloud_np(7, 60, spread=0.6)
    return params, degrees


@pytest.mark.parametrize("yaw,pitch", [(0.0, 0.0), (0.7, -0.3), (-2.1, 1.2), (0.4, math.pi / 2)])
def test_orbit_camera_matches_jax(yaw, pitch):
    target = np.array([0.1, -0.2, 3.0])
    t = tviewer._orbit_camera(yaw, pitch, 2.5, target, H, W)
    j = jviewer._orbit_camera(yaw, pitch, 2.5, target, H, W)
    assert (t.image_height, t.image_width) == (H, W)
    assert t.FoVx == pytest.approx(j.FoVx) and t.FoVy == pytest.approx(j.FoVy)
    for name in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_render_frame_png_and_overrides():
    params, degrees = scene()
    model = torch_model(params, degrees)
    app = tviewer.ViewerApp(model, height=H, width=W)
    assert app.last_frame_ms is None
    png = app.render_frame(yaw=0.3, pitch=0.1)
    assert png[:8] == PNG
    assert set(app.last_frame_ms) == {"render", "encode"}
    assert all(t > 0 for t in app.last_frame_ms.values())
    img = np.asarray(Image.open(io.BytesIO(png)))
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    with torch.no_grad():
        want = model(app.camera(0.3, 0.1))["render"]
    np.testing.assert_array_equal(img, tviewer.to_uint8(want))
    assert img.max() > 0
    assert app.render_frame(yaw=2.5, pitch=-0.4) != png
    png3 = app.render_frame(scale=0.5, sh_degree=0)
    assert model.scale_modifier == 1.0 and model.active_sh_degree == 3
    model.scale_modifier, model.active_sh_degree = 0.5, 0
    with torch.no_grad():
        small = tviewer.to_uint8(model(app.camera())["render"])
    model.scale_modifier, model.active_sh_degree = 1.0, 3
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png3))), small)


def test_frame_matches_jax_viewer():
    params, degrees = scene()
    t_app = tviewer.ViewerApp(torch_model(params, degrees), height=H, width=W)
    j_app = jviewer.ViewerApp(jax_model(params, degrees, render_backend="xla"), height=H,
                              width=W)
    np.testing.assert_allclose(t_app.target, j_app.target, rtol=0, atol=1e-7)
    assert t_app.default_radius == pytest.approx(j_app.default_radius, rel=1e-6)
    for kw in (dict(yaw=0.3, pitch=0.1), dict(yaw=-1.0, pitch=0.5, scale=0.7, sh_degree=1)):
        t = np.asarray(Image.open(io.BytesIO(t_app.render_frame(**kw)))).astype(int)
        j = np.asarray(Image.open(io.BytesIO(j_app.render_frame(**kw)))).astype(int)
        assert np.abs(t - j).max() <= 1, kw
        assert (t == j).mean() > 0.99


def test_http_surface():
    from http.server import ThreadingHTTPServer
    params, degrees = scene()
    app = tviewer.ViewerApp(torch_model(params, degrees), height=32, width=32)
    server = ThreadingHTTPServer(("127.0.0.1", 0), tviewer.make_handler(app))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        html = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read().decode()
        assert "<html" in html and "/render?" in html
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?yaw=0.2&pitch=0.1&scale=1&sh=2&radius=3"
            "&cx=0.1&cy=0&cz=3", timeout=120)
        body = resp.read()
        assert resp.headers["Content-Type"] == "image/png" and body[:8] == PNG
        assert float(resp.headers["X-Radius"]) == 3.0
        assert [float(resp.headers[k]) for k in ("X-Cx", "X-Cy", "X-Cz")] == [0.1, 0.0, 3.0]
        assert body == app.render_frame(yaw=0.2, pitch=0.1, radius=3.0,
                                        target=np.array([0.1, 0.0, 3.0]), sh_degree=2)
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/render", timeout=120)
        assert float(resp.headers["X-Radius"]) == pytest.approx(app.default_radius)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_load_model_honours_backend(tmp_path, monkeypatch):
    from reduced_3dgs_torch.shculling import (VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    params, degrees = scene()
    ply = str(tmp_path / "p.ply")
    torch_model(params, degrees).save_ply(ply)
    args = argparse.Namespace(load_ply=ply, destination=None, iteration=1, load_quantized=False,
                              sh_degree=3, backend="gsplat-2dgs", device="cpu")
    surfels = tviewer.load_model(args)
    assert type(surfels) is VariableSHGsplat2DGSGaussianModel and surfels.num_points == 60
    assert "normal" in tviewer.ViewerApp(surfels, 32, 32).model(
        tviewer._orbit_camera(0.0, 0.0, 2.0, np.zeros(3), 32, 32))
    args.backend = "cuda"
    assert type(tviewer.load_model(args)) is VariableSHGaussianModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tviewer.main(["-l", ply])

"""Interactive scene viewer (counterpart of reduced_3dgs_tpu/viewer.py).

A self-contained HTTP server with an orbit-control page: each frame is
rendered by the model on its device (the card by default, through the
forward compositor) and sent as a PNG.

Usage:
    python -m reduced_3dgs_torch.viewer -d output/truck -i 30000 [--port 8007]
    python -m reduced_3dgs_torch.viewer -l point_cloud.ply [--load_quantized]
    [--backend gsplat-2dgs] [--device cuda]

Controls: drag = orbit, wheel = dolly, shift-drag = pan; sliders for the
scale modifier and the active SH degree. ``--backend`` picks the model class
as ``train --backend`` does, so ``gsplat-2dgs`` views a surfel model as
surfels (the JAX viewer ignores the flag). ``--device`` defaults to ``cuda``
and raises without a GPU; ``--device cpu`` serves from the CPU.
"""
from __future__ import annotations

import argparse
import io
import math
import os
import threading
import time
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .dataset.camera import build_camera
from .utils import profiling
from .utils.device import resolve_device

INDEX_HTML = """<!DOCTYPE html>
<html><head><title>reduced-3dgs viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; }
 img { display:block; width:100vw; height:100vh; object-fit:contain; }
</style></head><body>
<div id="hud">
 scale <input id="sc" type="range" min="0.05" max="2" step="0.05" value="1">
 sh <input id="sh" type="range" min="0" max="3" step="1" value="3">
 <span id="stat"></span>
</div>
<img id="view">
<script>
let yaw=0, pitch=0, radius=null, cx=0, cy=0, cz=0, busy=false, dirty=true;
async function refresh() {
  if (busy) { dirty = true; return; }
  busy = true; dirty = false;
  const q = new URLSearchParams({yaw, pitch, cx, cy, cz,
    radius: radius===null ? '' : radius,
    scale: document.getElementById('sc').value,
    sh: document.getElementById('sh').value});
  const t0 = performance.now();
  const r = await fetch('/render?' + q);
  const blob = await r.blob();
  document.getElementById('view').src = URL.createObjectURL(blob);
  document.getElementById('stat').textContent =
    ' ' + (performance.now() - t0).toFixed(0) + ' ms';
  radius = parseFloat(r.headers.get('X-Radius'));
  cx = parseFloat(r.headers.get('X-Cx')); cy = parseFloat(r.headers.get('X-Cy'));
  cz = parseFloat(r.headers.get('X-Cz'));
  busy = false;
  if (dirty) refresh();
}
let drag = null;
onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {
  if (!drag) return;
  const [x0, y0, pan] = drag; drag = [e.clientX, e.clientY, pan];
  if (pan) {
    const s = radius * 0.002;
    cx -= (e.clientX - x0) * s * Math.cos(yaw); cz += (e.clientX - x0) * s * Math.sin(yaw);
    cy -= (e.clientY - y0) * s;
  } else { yaw += (e.clientX - x0) * 0.01; pitch += (e.clientY - y0) * 0.01;
           pitch = Math.max(-1.5, Math.min(1.5, pitch)); }
  refresh();
};
onwheel = e => { radius *= Math.exp(e.deltaY * 0.001); refresh(); };
document.getElementById('sc').oninput = refresh;
document.getElementById('sh').oninput = refresh;
refresh();
</script></body></html>
"""


def _orbit_camera(yaw, pitch, radius, target, height, width, fovy=math.radians(50),
                  device="cpu"):
    """Camera orbiting ``target``; world up follows the COLMAP y-down
    convention so COLMAP-trained scenes render upright."""
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy_, sy = math.cos(yaw), math.sin(yaw)
    C = target + radius * np.array([sy * cp, -sp, -cy_ * cp])
    f = target - C
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 1.0, 0.0])
    r = np.cross(up, f)
    if np.linalg.norm(r) < 1e-6:
        r = np.array([1.0, 0.0, 0.0])
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    M = np.stack([r, u, f])                     # world -> view rows (column math)
    T = -M @ C
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    return build_camera(height, width, fovx, fovy, R=M.T.astype(np.float32),
                        T=T.astype(np.float32), device=device)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """[3,H,W] in [0, 1] -> [H,W,3] uint8, truncating x 255 as the JAX
    viewer does."""
    arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
    with profiling.sync("frame_copy"):
        arr = arr.cpu()
    return arr.numpy().transpose(1, 2, 0)


def encode_png(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class ViewerApp:
    """Renders orbit frames of a model; shared by the HTTP handler and tests."""

    def __init__(self, model, height: int = 544, width: int = 960):
        self.model = model
        self.height = height
        self.width = width
        self._lock = threading.Lock()
        xyz = model._xyz.detach().cpu().numpy()
        self.target = (xyz.mean(0) if len(xyz) else np.zeros(3)).astype(np.float64)
        spread = float(np.percentile(np.linalg.norm(xyz - self.target, axis=1), 90)) \
            if len(xyz) else 1.0
        self.default_radius = max(2.0 * spread, 1e-2)
        # Milliseconds of the last served frame's render (with its copy to
        # the host) and PNG encode.
        self.last_frame_ms = None

    def camera(self, yaw: float = 0.0, pitch: float = 0.0, radius=None, target=None):
        radius = self.default_radius if radius is None else float(radius)
        target = self.target if target is None else np.asarray(target, float)
        return _orbit_camera(yaw, pitch, radius, target, self.height, self.width,
                             device=self.model.device)

    @torch.no_grad()
    def render_image(self, yaw: float = 0.0, pitch: float = 0.0, radius=None, target=None,
                     scale: float = 1.0, sh_degree=None) -> np.ndarray:
        """One orbit frame as [H,W,3] uint8; the model's scale modifier and
        active SH degree are set for it and restored after."""
        with profiling.span("frame"):
            cam = self.camera(yaw, pitch, radius, target)
            with self._lock:
                old_scale = self.model.scale_modifier
                old_deg = self.model.active_sh_degree
                try:
                    self.model.scale_modifier = float(scale)
                    if sh_degree is not None:
                        self.model.active_sh_degree = int(sh_degree)
                    img = self.model(cam)["render"]
                finally:
                    self.model.scale_modifier = old_scale
                    self.model.active_sh_degree = old_deg
            return to_uint8(img)

    def render_frame(self, yaw: float = 0.0, pitch: float = 0.0, radius=None, target=None,
                     scale: float = 1.0, sh_degree=None) -> bytes:
        """One orbit frame as PNG bytes; ``last_frame_ms`` holds its times."""
        t0 = time.perf_counter()
        arr = self.render_image(yaw, pitch, radius, target, scale, sh_degree)
        t1 = time.perf_counter()
        with profiling.span("encode"):
            png = encode_png(arr)
        self.last_frame_ms = {"render": (t1 - t0) * 1e3,
                              "encode": (time.perf_counter() - t1) * 1e3}
        return png


def make_handler(app: ViewerApp):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", INDEX_HTML.encode())
                return
            if u.path == "/render":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                radius = float(q["radius"]) if q.get("radius") else None
                target = None
                if q.get("cx"):
                    target = np.array([float(q.get("cx", 0)), float(q.get("cy", 0)),
                                       float(q.get("cz", 0))])
                    if not np.any(target):
                        target = None
                png = app.render_frame(
                    yaw=float(q.get("yaw", 0)), pitch=float(q.get("pitch", 0)),
                    radius=radius, target=target, scale=float(q.get("scale", 1)),
                    sh_degree=int(q["sh"]) if q.get("sh") else None)
                t = app.target if target is None else target
                r = app.default_radius if radius is None else radius
                self._send(200, "image/png", png, headers=[
                    ("X-Radius", str(r)), ("X-Cx", str(t[0])), ("X-Cy", str(t[1])),
                    ("X-Cz", str(t[2]))])
                return
            self._send(404, "text/plain", b"not found")

    return Handler


def load_model(args):
    """The model of ``args.backend``'s class on ``args.device``, from
    ``-l``'s PLY or the ``-d``/``-i`` run's (quantized) PLY."""
    from .prepare import get_gaussian_model_class
    from .quantization import VectorQuantizer
    ply = args.load_ply
    if ply is None:
        ply = os.path.join(args.destination, "point_cloud", f"iteration_{args.iteration}",
                           "point_cloud_quantized.ply" if args.load_quantized
                           else "point_cloud.ply")
    model = get_gaussian_model_class(args.backend)(args.sh_degree,
                                                   device=resolve_device(args.device))
    if args.load_quantized:
        VectorQuantizer().load_quantized(model, ply)
    else:
        model.load_ply(ply)
    model.init_degrees()
    model.active_sh_degree = args.sh_degree
    return model


def main(argv=None):
    from .prepare import backends
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--destination", default=None)
    parser.add_argument("-i", "--iteration", type=int, default=30000)
    parser.add_argument("-l", "--load_ply", default=None)
    parser.add_argument("--load_quantized", action="store_true")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--backend", choices=backends, default="cuda")
    parser.add_argument("--height", type=int, default=544)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--port", type=int, default=8007)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    if args.destination is None and args.load_ply is None:
        parser.error("need -d <model_dir> or -l <ply>")

    model = load_model(args)
    app = ViewerApp(model, args.height, args.width)
    from http.server import ThreadingHTTPServer
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(app))
    print(f"viewing {model.num_points} points at http://127.0.0.1:{args.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

"""Live web viewer: the headless-host equivalent of the reference's
interactive PCL visualizer (demo.cpp:374-506, 2/4 viewports + camera
controls, refused to run over SSH). PyTorch-port counterpart of
``sobfu_tpu.viewer``.

A GPU host often has no display, but it always has a port: `LiveViewer` runs a
tiny stdlib HTTP server in a daemon thread. The browser page (embedded,
zero external dependencies) polls `/state.json` and renders the current
meshes with a small software 3-D canvas renderer — orbit/zoom camera via
mouse drag/wheel, one viewport per pipeline volume, plus the live color
frame. Meshes are decimated server-side to keep updates light.

Usage:
    viewer = LiveViewer(port=8765)
    viewer.start()
    ...
    viewer.update(fusion, color=color_img, fps=current_fps)   # per frame
    viewer.stop()

or from the CLI: `python -m sobfu_tpu_torch ... --live-viz [--live-viz-port N]`.
"""

from __future__ import annotations

import base64
import io as _io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sobfu_tpu_torch live</title>
<style>
 body { background:#14151a; color:#ccc; font:12px sans-serif; margin:0; }
 #bar { padding:6px 10px; background:#1d1e24; }
 #panels { display:flex; flex-wrap:wrap; }
 .panel { margin:6px; }
 .panel canvas { background:#0c0d10; border:1px solid #333; }
 .panel div { text-align:center; padding:2px; }
 img { border:1px solid #333; }
</style></head><body>
<div id="bar">sobfu_tpu_torch live viewer — drag to orbit, wheel to zoom.
 <span id="stat"></span></div>
<div id="panels"></div>
<script>
let rotX = -0.4, rotY = 0.6, zoom = 1.0, seq = -1;
let dragging = false, lx = 0, ly = 0;
document.addEventListener('mousedown', e => { dragging = true; lx = e.clientX; ly = e.clientY; });
document.addEventListener('mouseup', () => dragging = false);
document.addEventListener('mousemove', e => {
  if (!dragging) return;
  rotY += (e.clientX - lx) * 0.01; rotX += (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; draw();
});
document.addEventListener('wheel', e => { zoom *= Math.exp(-e.deltaY * 0.001); draw(); });
let state = null;
function draw() {
  if (!state) return;
  const holder = document.getElementById('panels');
  for (const p of state.panels) {
    let el = document.getElementById('p_' + p.name);
    if (!el) {
      el = document.createElement('div'); el.className = 'panel'; el.id = 'p_' + p.name;
      el.innerHTML = '<canvas width="360" height="360"></canvas><div>' + p.name + '</div>';
      holder.appendChild(el);
    }
    const cv = el.querySelector('canvas'), ctx = cv.getContext('2d');
    ctx.clearRect(0, 0, cv.width, cv.height);
    const v = p.v;  // flat [x,y,z,...] triangle soup, centered+unit scaled
    const cx = Math.cos(rotX), sx = Math.sin(rotX), cy = Math.cos(rotY), sy = Math.sin(rotY);
    const n = v.length / 9, tris = [];
    for (let t = 0; t < n; t++) {
      const pts = [], zs = [];
      for (let k = 0; k < 3; k++) {
        let x = v[t*9 + k*3], y = v[t*9 + k*3 + 1], z = v[t*9 + k*3 + 2];
        let x1 = cy*x + sy*z, z1 = -sy*x + cy*z;
        let y1 = cx*y - sx*z1, z2 = sx*y + cx*z1;
        const s = 150 * zoom / (2.5 + z2);
        pts.push([180 + x1*s*2.5, 180 - y1*s*2.5]); zs.push(z2);
      }
      const az = (zs[0]+zs[1]+zs[2])/3;
      const ux = pts[1][0]-pts[0][0], uy = pts[1][1]-pts[0][1];
      const wx = pts[2][0]-pts[0][0], wy = pts[2][1]-pts[0][1];
      const shade = Math.max(0.25, Math.min(1, 0.55 + (ux*wy-uy*wx) * 0.0015));
      tris.push([az, pts, shade, p.c ? p.c[t] : null]);
    }
    tris.sort((a, b) => b[0] - a[0]);
    for (const [az, pts, shade, col] of tris) {
      ctx.beginPath();
      ctx.moveTo(pts[0][0], pts[0][1]); ctx.lineTo(pts[1][0], pts[1][1]);
      ctx.lineTo(pts[2][0], pts[2][1]); ctx.closePath();
      const rgb = col || [110, 140, 210];
      ctx.fillStyle = 'rgb(' + rgb.map(c => Math.round(c*shade)).join(',') + ')';
      ctx.fill();
    }
  }
  let img = document.getElementById('colorimg');
  if (state.color) {
    if (!img) {
      img = document.createElement('img'); img.id = 'colorimg';
      const el = document.createElement('div'); el.className = 'panel';
      el.appendChild(img);
      const cap = document.createElement('div'); cap.textContent = 'color';
      el.appendChild(cap);
      holder.appendChild(el);
    }
    img.src = 'data:image/png;base64,' + state.color;
  }
  document.getElementById('stat').textContent =
    ' frame ' + state.frame + (state.fps ? ' · ' + state.fps.toFixed(2) + ' fps' : '');
}
async function poll() {
  try {
    const r = await fetch('/state.json?seq=' + seq);
    const s = await r.json();
    if (s.seq !== seq) { seq = s.seq; state = s; draw(); }
  } catch (e) {}
  setTimeout(poll, 500);
}
poll();
</script></body></html>
"""


def _decimate_soup(vertices: np.ndarray, colors, max_tris: int = 3000):
    """Triangle-soup vertices [n,3] -> (flat list, per-tri color list)."""
    tris = np.asarray(vertices, np.float32).reshape(-1, 3, 3)
    tri_cols = None
    if colors is not None:
        tri_cols = np.asarray(colors, np.float32).reshape(-1, 3, 3).mean(axis=1)
    if tris.shape[0] > max_tris:
        idx = np.linspace(0, tris.shape[0] - 1, max_tris).astype(int)
        tris = tris[idx]
        if tri_cols is not None:
            tri_cols = tri_cols[idx]
    if tris.shape[0]:
        center = tris.reshape(-1, 3).mean(axis=0)
        scale = max(float(np.abs(tris.reshape(-1, 3) - center).max()), 1e-9)
        tris = (tris - center) / scale
    flat = np.round(tris.reshape(-1), 4).tolist()
    cols = (
        np.round(tri_cols, 0).astype(int).tolist()
        if tri_cols is not None else None
    )
    return flat, cols


def _png_b64(img: np.ndarray) -> str:
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class LiveViewer:
    """Serve a live view of the reconstruction over HTTP."""

    def __init__(self, port: int = 8765, host: str = "127.0.0.1",
                 max_tris: int = 3000):
        self.port = port
        self.host = host
        self.max_tris = max_tris
        self._lock = threading.Lock()
        self._state = {"seq": 0, "frame": 0, "panels": [], "color": None,
                       "fps": None}
        self._server = None
        self._thread = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    ctype = "application/json"
                elif self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    # -- updates ------------------------------------------------------------

    def update_meshes(self, named_meshes, color=None, fps=None,
                      frame=None) -> None:
        """named_meshes: iterable of (name, Mesh)."""
        panels = []
        for name, mesh in named_meshes:
            flat, cols = _decimate_soup(
                mesh.vertices, getattr(mesh, "colors", None), self.max_tris
            )
            panel = {"name": name, "v": flat}
            if cols is not None:
                panel["c"] = cols
            panels.append(panel)
        with self._lock:
            self._state["seq"] += 1
            self._state["panels"] = panels
            if frame is not None:
                self._state["frame"] = frame
            else:
                self._state["frame"] += 1
            if fps is not None:
                self._state["fps"] = float(fps)
            self._state["color"] = (
                _png_b64(color) if color is not None else None
            )

    def update(self, fusion, color=None, fps=None, detailed: bool = False,
               frame=None) -> None:
        """Pull the current meshes from a SobFusion pipeline and publish."""
        panels = [
            ("phi_global", fusion.get_phi_global_mesh()),
            ("phi_n(psi)", fusion.get_phi_n_psi_mesh()),
        ]
        if detailed:
            panels += [
                ("phi_n", fusion.get_phi_n_mesh()),
                ("phi_global(psi_inv)", fusion.get_phi_global_psi_inv_mesh()),
            ]
        self.update_meshes(panels, color=color, fps=fps, frame=frame)

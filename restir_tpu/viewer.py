"""Interactive browser viewer — the counterpart of the
reference's GLFW/ImGui preview (preview.cpp:141-369, SURVEY.md L7): an
MJPEG stream over HTTP with WASD/mouse-drag camera controls and a live
settings panel (tracer, reuse mode, denoiser, tonemap, fps readout).

Everything renders headlessly on the device; the browser only displays
JPEG frames. Camera changes reset the accumulation counter exactly like
the reference's camchanged path (main.cpp:155-162).

Usage: python -m restir_tpu --builtin cornell --serve 8000
"""

from __future__ import annotations

import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>restir_tpu viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:0; display:flex; }
#img { image-rendering:pixelated; cursor:grab; }
#panel { padding:12px; min-width:230px; }
select,button { background:#222; color:#ccc; border:1px solid #444; margin:2px 0; width:100%%; }
</style></head><body>
<img id="img" src="/stream">
<div id="panel">
  <div id="stats">...</div><hr>
  tracer <select id="tracer"><option>restir_di</option><option>pt_direct</option>
    <option>pt_full</option><option>restir_gi</option><option>bvh</option>
    <option>gbuffer</option></select>
  reuse <select id="reuse"><option>spatiotemporal</option><option>temporal</option>
    <option>spatial</option><option>none</option></select>
  denoiser <select id="denoiser"><option>none</option><option>eaw</option>
    <option>svgf</option></select>
  tonemap <select id="tonemap"><option>aces</option><option>filmic</option>
    <option>none</option></select>
  gbuffer ch <select id="gbchannel"><option>normal</option><option>albedo</option>
    <option>depth</option><option>position</option></select>
  <label>sig_lum <input id="sig_luminance" type="range" min="0.1" max="4" step="0.1" value="1"></label>
  <label>sig_normal <input id="sig_normal" type="range" min="0.01" max="1" step="0.01" value="0.2"></label>
  <label>sig_depth <input id="sig_depth" type="range" min="1" max="256" step="1" value="64"></label>
  <button onclick="send('/ctl?reset=1')">reset accumulation</button>
  <div>WASD+QE move, drag to look</div>
</div>
<script>
const send = (u) => fetch(u);
for (const id of ["tracer","reuse","denoiser","tonemap","gbchannel"]) {
  document.getElementById(id).onchange = (e) => send(`/ctl?${id}=${e.target.value}`);
}
for (const id of ["sig_luminance","sig_normal","sig_depth"]) {
  document.getElementById(id).onchange = (e) => send(`/ctl?${id}=${e.target.value}`);
}
document.addEventListener("keydown", (e) => {
  const k = e.key.toLowerCase();
  if ("wasdqe".includes(k)) send(`/ctl?key=${k}`);
});
let drag = null;
const img = document.getElementById("img");
img.onmousedown = (e) => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = (e) => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  send(`/ctl?yaw=${dx}&pitch=${dy}`);
};
setInterval(async () => {
  const s = await (await fetch("/stats")).json();
  document.getElementById("stats").textContent =
    `${s.fps.toFixed(1)} fps | iter ${s.iteration} | ${s.width}x${s.height}`;
}, 1000);
</script></body></html>"""


class ViewerState:
    """Shared mutable settings blackboard (the Settings analogue)."""

    def __init__(self, cfg, cam):
        self.lock = threading.Lock()
        self.cfg = cfg
        self.position = np.asarray(cam.position, np.float32).copy()
        self.rotation = np.asarray(cam.rotation, np.float32).copy()
        self.cam_changed = False
        self.cfg_changed = False
        self.frame_jpeg = b""
        self.fps = 0.0
        self.iteration = 0
        self.running = True


def _render_loop(scene, state: ViewerState):
    import jax.numpy as jnp

    from . import renderer
    from .config import DenoiserType, ReuseMode, ToneMapping, TracerType
    from .ops.camera import make_camera
    from PIL import Image

    tracer_map = {
        "restir_di": TracerType.RESTIR_DI, "pt_direct": TracerType.PT_DIRECT,
        "pt_full": TracerType.PT_FULL, "restir_gi": TracerType.RESTIR_GI,
        "bvh": TracerType.BVH_VISUALIZE, "gbuffer": TracerType.GBUFFER_PREVIEW,
    }

    with state.lock:
        cfg = state.cfg
        cam = make_camera(state.position, state.rotation)
    rstate = renderer.init_state(cfg, cam, scene)
    t_last = time.time()
    while state.running:
        with state.lock:
            if state.cfg_changed:
                cfg = state.cfg
                rstate = renderer.init_state(cfg, cam, scene)
                state.cfg_changed = False
            if state.cam_changed:
                cam = make_camera(state.position, state.rotation)
                rstate = renderer.reset_iteration(rstate)
                state.cam_changed = False
        rstate, frame = renderer.step_jit(scene, rstate, cam, cfg)
        img = np.asarray(renderer.frame_to_image_jit(frame, cfg))
        buf = io.BytesIO()
        Image.fromarray(img[:, ::-1]).save(buf, "JPEG", quality=85)
        now = time.time()
        with state.lock:
            state.frame_jpeg = buf.getvalue()
            state.fps = 0.9 * state.fps + 0.1 / max(now - t_last, 1e-6)
            state.iteration = int(rstate.iteration)
        t_last = now


def serve(scene, cfg, cam, port: int = 8000, host: str = "127.0.0.1"):
    """Blocking: render loop + HTTP viewer on the given port.

    Binds loopback by default — the control endpoint is unauthenticated,
    so exposing it on all interfaces must be an explicit choice
    (pass host="0.0.0.0")."""
    state = ViewerState(cfg, cam)
    t = threading.Thread(target=_render_loop, args=(scene, state), daemon=True)
    t.start()

    move = {
        "w": (0, 0, -0.25), "s": (0, 0, 0.25), "a": (-0.25, 0, 0),
        "d": (0.25, 0, 0), "q": (0, -0.25, 0), "e": (0, 0.25, 0),
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/stats":
                with state.lock:
                    body = json.dumps({
                        "fps": state.fps, "iteration": state.iteration,
                        "width": state.cfg.width, "height": state.cfg.height,
                    }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                try:
                    while state.running:
                        with state.lock:
                            jpeg = state.frame_jpeg
                        if jpeg:
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                                + jpeg + b"\r\n"
                            )
                        time.sleep(0.05)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif url.path == "/ctl":
                q = parse_qs(url.query)
                from .config import DenoiserType, ReuseMode, ToneMapping, TracerType

                def safe_float(vals, default=0.0):
                    try:
                        v = float(vals[0])
                    except (TypeError, ValueError, IndexError):
                        return default
                    return v if math.isfinite(v) else default

                with state.lock:
                    step_xyz = move.get(q.get("key", [None])[0])
                    if step_xyz is not None:
                        dx, dy, dz = step_xyz
                        # move in the camera frame (view/right from rotation)
                        yaw = np.deg2rad(state.rotation[0])
                        fwd = np.array([np.cos(yaw), 0, np.sin(yaw)], np.float32)
                        right = np.array([-np.sin(yaw), 0, np.cos(yaw)], np.float32)
                        state.position = (
                            state.position + right * dx
                            + np.array([0, dy, 0], np.float32) - fwd * dz
                        )
                        state.cam_changed = True
                    if "yaw" in q or "pitch" in q:
                        state.rotation[0] += safe_float(q.get("yaw", [0])) * 0.3
                        state.rotation[1] -= safe_float(q.get("pitch", [0])) * 0.3
                        state.rotation[1] = float(np.clip(state.rotation[1], -89, 89))
                        state.cam_changed = True
                    if "reset" in q:
                        state.cam_changed = True
                    maps = {
                        "tracer": ("tracer", {
                            "restir_di": TracerType.RESTIR_DI,
                            "pt_direct": TracerType.PT_DIRECT,
                            "pt_full": TracerType.PT_FULL,
                            "restir_gi": TracerType.RESTIR_GI,
                            "bvh": TracerType.BVH_VISUALIZE,
                            "gbuffer": TracerType.GBUFFER_PREVIEW,
                        }),
                        "reuse": ("reuse", {
                            "none": ReuseMode.NONE,
                            "temporal": ReuseMode.TEMPORAL,
                            "spatial": ReuseMode.SPATIAL,
                            "spatiotemporal": ReuseMode.SPATIOTEMPORAL,
                        }),
                        "denoiser": ("denoiser", {
                            "none": DenoiserType.NONE,
                            "eaw": DenoiserType.EAW,
                            "svgf": DenoiserType.SVGF,
                        }),
                        "tonemap": ("tone_mapping", {
                            "none": ToneMapping.NONE,
                            "filmic": ToneMapping.FILMIC,
                            "aces": ToneMapping.ACES,
                        }),
                        "gbchannel": ("gbuffer_channel", {
                            "normal": "normal", "albedo": "albedo",
                            "depth": "depth", "position": "position",
                        }),
                    }
                    for key, (field, mapping) in maps.items():
                        if key in q and q[key][0] in mapping:
                            state.cfg = state.cfg.replace(
                                **{field: mapping[q[key][0]]}
                            )
                            state.cfg_changed = True
                    # denoiser sigma sliders (preview.cpp:253-263)
                    for field in ("sig_luminance", "sig_normal", "sig_depth"):
                        if field in q:
                            v = safe_float(q[field], None)
                            if v is not None and v > 0:
                                state.cfg = state.cfg.replace(**{field: v})
                                state.cfg_changed = True
                self.send_response(204)
                self.end_headers()
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    print(f"[viewer] http://localhost:{port}/  (ctrl-c to stop)")
    try:
        server.serve_forever()
    finally:
        state.running = False

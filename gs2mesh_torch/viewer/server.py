"""Browser viewer server: orbit camera -> K1/K2 render -> PNG stream (port
of gs2mesh_tpu viewer/server.py).

Replaces the reference's offline SIBR gaussian viewer
(SIBR_viewers/src/projects/gaussianviewer): the port's own rasterizer
renders every requested pose on the card (kernels K1 and K2) and the
browser is a thin controller (vanilla JS, no dependencies). PNGs are
encoded by ``core/png.py``. A pose whose frame needs more pairs than
``pair_capacity`` is answered with status 507 and a message naming
``--pair-capacity``; the server keeps serving.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.camera import Camera, make_camera
from gs2mesh_torch.core.png import encode_png


def orbit_camera(target, radius: float, azimuth_deg: float,
                 elevation_deg: float, fov_deg: float,
                 width: int, height: int, device="cuda") -> Camera:
    """Look-at camera on an orbit around ``target`` (GS conventions)."""
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    target = np.asarray(target, np.float64)
    eye = target + radius * np.array([
        math.cos(el) * math.sin(az),
        math.sin(el),
        -math.cos(el) * math.cos(az)])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up_world = np.array([0.0, -1.0, 0.0])     # GS/COLMAP: y points down
    right = np.cross(up_world, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:                              # looking straight up/down
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(fwd, right)
    Rw2v = np.stack([right, down, fwd], axis=0)
    T = -Rw2v @ eye
    fovx = math.radians(fov_deg)
    fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
    return make_camera(Rw2v.T, T, fovx, fovy, width, height, device=device)


def quantize(image: torch.Tensor) -> np.ndarray:
    """(3, H, W) float image -> (H, W, 3) uint8 as the viewer sends it:
    clamped to [0, 1], then (x * 255 + 0.5) truncated."""
    img = torch.clamp(image, 0.0, 1.0).permute(1, 2, 0)
    return (img * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


class PairCapacityError(RuntimeError):
    """A frame needs more (tile, gaussian) pairs than the server holds."""


_PAGE = """<!doctype html>
<meta charset="utf-8"><title>gs2mesh_torch viewer</title>
<style>
 body{margin:0;background:#111;color:#ccc;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:6px;user-select:none}
 img{display:block;width:100vw;height:100vh;object-fit:contain;
     image-rendering:auto;cursor:grab}
</style>
<div id="hud">gs2mesh_torch viewer — drag: orbit · shift/right-drag: pan ·
wheel: dolly · <span id="st"></span></div>
<img id="v" draggable="false">
<script>
let az=INIT_AZ, el=INIT_EL, r=INIT_R, fov=INIT_FOV;
let t=[INIT_TX,INIT_TY,INIT_TZ];
let busy=false, dirty=true;
const img=document.getElementById('v'), st=document.getElementById('st');
function url(){return `/render?az=${az.toFixed(2)}&el=${el.toFixed(2)}`+
  `&r=${r.toFixed(4)}&tx=${t[0].toFixed(4)}&ty=${t[1].toFixed(4)}`+
  `&tz=${t[2].toFixed(4)}&fov=${fov.toFixed(1)}`;}
async function tick(){
  if(!dirty||busy){requestAnimationFrame(tick);return;}
  busy=true;dirty=false;const t0=performance.now();
  try{const rsp=await fetch(url());const b=await rsp.blob();
      img.src=URL.createObjectURL(b);
      st.textContent=`${(performance.now()-t0).toFixed(0)} ms`;}
  catch(e){st.textContent='error';}
  busy=false;requestAnimationFrame(tick);}
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY,e.buttons,
  e.shiftKey];img.setPointerCapture(e.pointerId);});
img.addEventListener('pointerup',()=>drag=null);
img.addEventListener('contextmenu',e=>e.preventDefault());
img.addEventListener('pointermove',e=>{
  if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  drag[0]=e.clientX;drag[1]=e.clientY;
  if(drag[2]&2||drag[3]){   // pan in view plane
    const s=r*0.002, a=az*Math.PI/180, elr=el*Math.PI/180;
    const right=[Math.cos(a),0,Math.sin(a)];
    const up=[-Math.sin(elr)*Math.sin(a),Math.cos(elr),
              Math.sin(elr)*Math.cos(a)];
    for(let i=0;i<3;i++)t[i]+=(-dx*right[i]+dy*up[i])*s;
  }else{az+=dx*0.4;el=Math.max(-89,Math.min(89,el+dy*0.4));}
  dirty=true;});
addEventListener('wheel',e=>{r*=Math.exp(e.deltaY*0.001);dirty=true;});
tick();
</script>
"""


class ViewerServer:
    """HTTP viewer over a loaded GaussianModel, rendering on ``device``.

    Usage:
        ViewerServer(model).serve()            # blocks; open the URL
        srv = ViewerServer(model); srv.start() # background thread

    ``timings`` keeps, per rendered request, the render's wall ms (ending
    when the frame is on the host), its device ms (CUDA events; None on the
    CPU) and the PNG encode ms.
    """

    def __init__(self, model, width: int = 960, height: int = 540,
                 pair_capacity: int = 1 << 21, port: int = 8090,
                 white_background: bool = False, host: str = "127.0.0.1",
                 device="cuda"):
        from gs2mesh_torch.models.gaussians import GaussianParams
        from gs2mesh_torch.ops.rasterizer import RasterizerConfig

        self.device = torch.empty(0, device=resolve_device(device)).device
        self.width, self.height = int(width), int(height)
        self.port = port
        # Loopback by default: the render endpoint drives the card, so
        # external exposure must be an explicit opt-in (host="0.0.0.0").
        self.host = host
        self.rcfg = RasterizerConfig(pair_capacity=pair_capacity)
        self.bg = torch.full((3,), 1.0 if white_background else 0.0,
                             dtype=torch.float32, device=self.device)
        self.params = GaussianParams(*[t.detach().to(self.device)
                                       for t in model.params.tensors()])
        self.alive = (None if model.alive is None
                      else model.alive.to(self.device))
        self.sh_degree = model.max_sh_degree
        self._lock = threading.Lock()
        self._httpd = None
        self.timings = []

        xyz = self.params.xyz.cpu().numpy()
        alive = (np.ones(len(xyz), bool) if self.alive is None
                 else self.alive.cpu().numpy())
        pts = xyz[alive] if alive.any() else xyz
        self.target = pts.mean(axis=0)
        self.radius = float(np.percentile(
            np.linalg.norm(pts - self.target, axis=1), 90) * 2.5) or 3.0

    # -- rendering -------------------------------------------------------
    def render_frame(self, cam: Camera) -> np.ndarray:
        """(H, W, 3) uint8 frame of ``cam`` (kernels K1 and K2 on the card).
        Raises PairCapacityError when the frame overflows pair_capacity."""
        from gs2mesh_torch.train.trainer import render_model

        cuda = self.device.type == "cuda"
        with self._lock, torch.no_grad():       # one card user at a time
            t0 = time.perf_counter()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            out = render_model(self.params, self.alive, cam, self.sh_degree,
                               self.bg, self.rcfg)
            if cuda:
                ev[1].record()
            overflow = bool(out.overflow) or bool(out.tile_overflow)
            frame = None if overflow else quantize(out.image)
            wall = (time.perf_counter() - t0) * 1e3
            dev_ms = ev[0].elapsed_time(ev[1]) if cuda else None
        if overflow:
            raise PairCapacityError(
                f"this view needs {int(out.num_pairs)} pairs, over the "
                f"pair capacity {self.rcfg.pair_capacity}: restart the "
                f"viewer with a larger --pair-capacity")
        self.timings.append({"render_ms": wall, "device_ms": dev_ms})
        return frame

    def render_png(self, az: float, el: float, r: float, target,
                   fov: float) -> bytes:
        cam = orbit_camera(target, r, az, el, fov, self.width, self.height,
                           device=self.device)
        frame = self.render_frame(cam)
        t0 = time.perf_counter()
        png = encode_png(frame)
        self.timings[-1]["encode_ms"] = (time.perf_counter() - t0) * 1e3
        return png

    # -- http ------------------------------------------------------------
    def _handler(self):
        viewer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    page = (_PAGE
                            .replace("INIT_AZ", "0")
                            .replace("INIT_EL", "15")
                            .replace("INIT_R", f"{viewer.radius:.4f}")
                            .replace("INIT_FOV", "60")
                            .replace("INIT_TX", f"{viewer.target[0]:.4f}")
                            .replace("INIT_TY", f"{viewer.target[1]:.4f}")
                            .replace("INIT_TZ", f"{viewer.target[2]:.4f}"))
                    self._send(200, "text/html", page.encode())
                elif u.path == "/info":
                    self._send(200, "application/json", json.dumps({
                        "width": viewer.width, "height": viewer.height,
                        "target": viewer.target.tolist(),
                        "radius": viewer.radius}).encode())
                elif u.path == "/render":
                    try:
                        q = {k: float(v[0])
                             for k, v in parse_qs(u.query).items()}
                    except (ValueError, TypeError):
                        self._send(400, "text/plain", b"bad query param")
                        return
                    try:
                        png = viewer.render_png(
                            q.get("az", 0.0), q.get("el", 15.0),
                            q.get("r", viewer.radius),
                            (q.get("tx", viewer.target[0]),
                             q.get("ty", viewer.target[1]),
                             q.get("tz", viewer.target[2])),
                            q.get("fov", 60.0))
                    except PairCapacityError as e:
                        self._send(507, "text/plain", str(e).encode())
                        return
                    self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")

        return H

    def start(self):
        """Start serving on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler())
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def serve(self):
        port = self.start()
        print(f"gs2mesh_torch viewer at http://localhost:{port}/  "
              f"(Ctrl-C to stop)")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            self.stop()

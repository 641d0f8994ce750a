"""The port's viewer (gs2mesh_torch.viewer, cli/view) and SIBR network GUI
(train/network_gui, gs_tools train --gui), held to the JAX package's.

* orbit_camera equals JAX's (world_view, full_proj, cam_center within 1e-6).
* The HTTP server on port 0 at 96x64 (400 gaussians): /, /info and /render
  at 3 poses; each PNG decodes to the port's quantised render of that orbit
  camera byte for byte and lies within 1/255 of JAX's ViewerServer PNG
  (JAX in exact carry); an overflowing /render answers 507 naming
  --pair-capacity and the next request succeeds.
* cli/view parses its arguments as JAX's does.
* A scripted SIBR client on a real localhost socket: the parsed camera
  equals JAX's, the bytes are W*H*3 and then the verify string, the frame
  is the port's render of that camera; gs_train(gui=True) trains with a
  client attached.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gs2mesh_torch.core.png import decode_png
from gs2mesh_torch.models.gaussians import (GaussianModel, params_from_numpy,
                                            state_from_numpy)
from gs2mesh_torch.ops.rasterizer import RasterizerConfig
from gs2mesh_torch.train.network_gui import (NetworkGUI, frame_bytes,
                                             serve_step)
from gs2mesh_torch.train.trainer import render_model
from gs2mesh_torch.viewer import ViewerServer, orbit_camera, quantize
from tests.test_torch_core import assert_camera_close

torch.set_num_threads(2)

POSES = [(30.0, 10.0), (120.0, -20.0), (-75.0, 35.0)]
EXACT = dict(feat_carry_bf16=False, grad_carry_bf16=False)


@pytest.mark.parametrize("args", [
    ((0.1, -0.2, 0.3), 2.0, 33.0, 21.0, 60.0, 96, 64),
    ((0.0, 0.0, 0.0), 3.5, -140.0, -60.0, 45.0, 960, 540),
    ((1.0, 2.0, -1.0), 0.7, 0.0, 89.0, 75.0, 64, 96),
    ((0.0, 0.5, 0.0), 2.0, 10.0, 90.0, 60.0, 32, 32)])   # looking down
def test_orbit_camera_matches_jax(args):
    from gs2mesh_tpu.viewer import orbit_camera as j_orbit

    assert_camera_close(orbit_camera(*args, device="cpu"), j_orbit(*args),
                        tol=1e-6)


def jax_model():
    from gs2mesh_tpu.models.gaussians import GaussianModel as JModel

    rng = np.random.default_rng(0)
    v = rng.normal(size=(400, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return JModel.from_point_cloud(v.astype(np.float32),
                                   rng.uniform(0.2, 0.9, (400, 3)),
                                   max_sh_degree=0)


def port_model(jm):
    return GaussianModel(
        params_from_numpy({k: np.asarray(v) for k, v in
                           zip(jm.params._fields, jm.params)}, "cpu"),
        max_sh_degree=jm.max_sh_degree,
        state=state_from_numpy({k: np.asarray(v) for k, v in
                                zip(jm.state._fields, jm.state)}, "cpu"))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


@pytest.fixture(scope="module")
def servers():
    """The port's and JAX's servers over the same 400-gaussian model (JAX's
    rasterizer config in the exact-carry mode the port implements)."""
    import gs2mesh_tpu.ops.rasterizer as jr
    from gs2mesh_tpu.viewer import ViewerServer as JServer

    jm = jax_model()
    with pytest.MonkeyPatch.context() as mp:
        cfg = jr.RasterizerConfig
        mp.setattr(jr, "RasterizerConfig",
                   lambda **kw: cfg(**{**kw, **EXACT}))
        jsrv = JServer(jm, width=96, height=64, pair_capacity=1 << 14,
                       port=0)
    srv = ViewerServer(port_model(jm), width=96, height=64,
                       pair_capacity=1 << 14, port=0, device="cpu")
    ports = srv.start(), jsrv.start()
    yield srv, jsrv, ports
    srv.stop()
    jsrv.stop()


def test_viewer_page_and_info(servers):
    srv, jsrv, (port, jport) = servers
    page, ctype = _get(port, "/")
    assert ctype.startswith("text/html") and b"gs2mesh_torch viewer" in page
    jpage, _ = _get(jport, "/")
    assert page.replace(b"gs2mesh_torch", b"gs2mesh_tpu") == jpage
    info = json.loads(_get(port, "/info")[0])
    jinfo = json.loads(_get(jport, "/info")[0])
    assert (info["width"], info["height"]) == (96, 64)
    np.testing.assert_allclose(info["target"], jinfo["target"], atol=1e-6)
    assert info["radius"] == pytest.approx(jinfo["radius"], rel=1e-6)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nothing")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/render?az=x")
    assert e.value.code == 400


@pytest.mark.parametrize("pose", POSES)
def test_viewer_render_matches_port_render_and_jax(servers, pose):
    from PIL import Image
    import io

    srv, _, (port, jport) = servers
    az, el = pose
    q = f"/render?az={az}&el={el}"
    png, ctype = _get(port, q)
    assert ctype == "image/png"
    img = decode_png(png)
    cam = orbit_camera(srv.target, srv.radius, az, el, 60.0, 96, 64,
                       device="cpu")
    with torch.no_grad():
        out = render_model(srv.params, srv.alive, cam, 0, torch.zeros(3),
                           RasterizerConfig(pair_capacity=1 << 14))
    np.testing.assert_array_equal(img, quantize(out.image))
    assert img.shape == (64, 96, 3) and img.max() > 0
    jimg = np.asarray(Image.open(io.BytesIO(_get(jport, q)[0])))
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    t = srv.timings[-1]
    assert t["render_ms"] > 0 and t["encode_ms"] > 0 and t["device_ms"] is None


def test_viewer_overflow_answers_507_and_keeps_serving():
    jm = jax_model()
    probe = ViewerServer(port_model(jm), width=96, height=64, port=0,
                         device="cpu")
    near, far = (probe.target, probe.radius * 0.6), (probe.target,
                                                     probe.radius * 4.0)
    counts = []
    for target, r in (near, far):
        cam = orbit_camera(target, r, 0.0, 15.0, 60.0, 96, 64, device="cpu")
        with torch.no_grad():
            counts.append(int(render_model(
                probe.params, probe.alive, cam, 0, torch.zeros(3),
                probe.rcfg).num_pairs))
    assert counts[1] < counts[0]
    srv = ViewerServer(port_model(jm), width=96, height=64,
                       pair_capacity=counts[1], port=0, device="cpu")
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, f"/render?az=0&el=15&r={near[1]}")
        assert e.value.code == 507
        assert b"--pair-capacity" in e.value.read()
        png, _ = _get(port, f"/render?az=0&el=15&r={far[1]}")
        assert decode_png(png).shape == (64, 96, 3)
    finally:
        srv.stop()


def test_view_cli_parses_like_jax(monkeypatch):
    from gs2mesh_torch.cli import view
    from gs2mesh_tpu.cli import view as jview
    import gs2mesh_tpu.models.gaussians as jg
    import gs2mesh_tpu.viewer as jviewer
    import gs2mesh_torch.viewer as pviewer

    calls = {}

    def fake_server(tag):
        class S:
            def __init__(self, model, **kw):
                calls[tag] = (model, kw)

            def serve(self):
                pass
        return S

    def fake_load(tag):
        return staticmethod(lambda path, max_sh_degree=3, **kw:
                            (tag, path, max_sh_degree))

    monkeypatch.setattr(jviewer, "ViewerServer", fake_server("jax"))
    monkeypatch.setattr(pviewer, "ViewerServer", fake_server("port"))
    monkeypatch.setattr(jg.GaussianModel, "load_ply", fake_load("jax"))
    monkeypatch.setattr(GaussianModel, "load_ply", fake_load("port"))
    for argv in (["m.ply"],
                 ["x/m.ply", "--port", "0", "--host", "0.0.0.0", "--width",
                  "320", "--height", "200", "--sh-degree", "1",
                  "--pair-capacity", "4096", "--white-background"]):
        jview.main(argv)
        view.main(argv, device="cpu")
        (jm, jkw), (pm, pkw) = calls["jax"], calls["port"]
        assert jm[1:] == pm[1:]
        assert pkw.pop("device") == "cpu"
        assert jkw == pkw


# ---------------------------------------------------------------------------
# The SIBR network GUI
# ---------------------------------------------------------------------------

def sibr_message(cam, train=True, keep_alive=False, scaling=1.0):
    """What the SIBR client sends for ``cam``: the GS matrices with the
    sign flips the server undoes."""
    view = cam.world_view.numpy().copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = cam.full_proj.numpy().copy()
    proj[:, 1] *= -1
    return dict(resolution_x=cam.width, resolution_y=cam.height, train=train,
                keep_alive=keep_alive, scaling_modifier=scaling,
                view_matrix=view.reshape(-1).tolist(),
                view_projection_matrix=proj.reshape(-1).tolist(),
                fov_x=2 * float(np.arctan(float(cam.tan_fovx))),
                fov_y=2 * float(np.arctan(float(cam.tan_fovy))),
                z_near=0.01, z_far=100.0)


def _recv_exact(s, n):
    """n bytes, or None once the server has closed the connection."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = s.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def sibr_client(port, messages, result, connect_for=30.0):
    """Connects (retrying until connect_for seconds), then for each message
    sends it and reads W*H*3 frame bytes and the verify string; stops when
    the server closes the connection."""
    deadline = time.time() + connect_for
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.01)
    frames = []
    with s:
        for msg in messages:
            payload = json.dumps(msg).encode("utf-8")
            try:
                s.sendall(len(payload).to_bytes(4, "little") + payload)
            except OSError:
                break
            img = _recv_exact(s, msg["resolution_x"] * msg["resolution_y"]
                              * 3)
            vlen = _recv_exact(s, 4) if img is not None else None
            if vlen is None:
                break
            verify = _recv_exact(s, int.from_bytes(vlen, "little"))
            frames.append((img, verify.decode("ascii")))
    result["frames"] = frames


def serve_one(gui_cls, serve, render_fn, msg):
    """One serve_step of ``serve`` against a scripted client sending msg."""
    gui = gui_cls(host="127.0.0.1", port=0)
    port = gui.listener.getsockname()[1]
    result = {}
    t = threading.Thread(target=sibr_client, args=(port, [msg], result))
    t.start()
    keep = False
    for _ in range(2000):
        gui.try_connect()
        if gui.conn is not None:
            keep = serve(gui, render_fn, iteration=10, total=100,
                         source_path="/data/scene")
            break
        time.sleep(0.005)
    t.join(timeout=60)
    gui.disconnect()
    gui.listener.close()
    return keep, result["frames"]


@pytest.fixture(scope="module")
def gui_case():
    from tests.test_torch_core import look_at_camera

    model = port_model(jax_model())
    cam = look_at_camera((0.4, -0.3, -2.8), 48, 32)
    return model, cam, sibr_message(cam)


def test_network_gui_camera_matches_jax(gui_case):
    from gs2mesh_tpu.train.network_gui import NetworkGUI as JGUI
    from gs2mesh_tpu.train.network_gui import serve_step as j_serve

    _, cam, msg = gui_case
    got = {}

    def port_render(c, scaling):
        got["port"] = (c, scaling)
        return torch.full((3, c.height, c.width), 0.5)

    def jax_render(c, scaling):
        got["jax"] = (c, scaling)
        return np.full((3, c.height, c.width), 0.5, np.float32)

    keep, frames = serve_one(NetworkGUI, lambda *a, **k: serve_step(
        *a, **k, device="cpu"), port_render, msg)
    jkeep, jframes = serve_one(JGUI, j_serve, jax_render, msg)
    assert keep is jkeep is True
    assert frames == jframes
    assert_camera_close(got["port"][0], got["jax"][0], tol=1e-6)
    for f in ("tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(got["port"][0], f).numpy(),
                                   np.asarray(getattr(got["jax"][0], f)),
                                   rtol=1e-6)
    assert got["port"][1] == got["jax"][1] == 1.0
    # The client's GS camera comes back.
    assert_camera_close(got["port"][0], cam, tol=1e-5)


def test_network_gui_frame_is_the_render(gui_case):
    model, cam, msg = gui_case
    rcfg = RasterizerConfig(pair_capacity=1 << 14)
    seen = {}

    def render_fn(c, scaling):
        seen["cam"] = c
        return render_model(model.params, model.alive, c, 0, torch.zeros(3),
                            rcfg, scale_modifier=scaling).image

    keep, frames = serve_one(NetworkGUI, lambda *a, **k: serve_step(
        *a, **k, device="cpu"), render_fn, msg)
    assert keep is True and len(frames) == 1
    img, verify = frames[0]
    assert len(img) == cam.width * cam.height * 3
    assert verify == "/data/scene"
    with torch.no_grad():
        ref = render_model(model.params, model.alive, seen["cam"], 0,
                           torch.zeros(3), rcfg).image
    assert img == frame_bytes(ref)
    assert max(img) > 0


def test_network_gui_drops_a_bad_client():
    """Any exception while serving disconnects the client (serve_step
    returns False, the trainer goes on)."""
    gui = NetworkGUI(host="127.0.0.1", port=0)
    port = gui.listener.getsockname()[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall((7).to_bytes(4, "little") + b"{notjs}")
    for _ in range(2000):
        gui.try_connect()
        if gui.conn is not None:
            break
        time.sleep(0.005)
    assert serve_step(gui, None, 1, 10, "src", device="cpu") is False
    assert gui.conn is None
    s.close()
    gui.close()


def test_gs_train_gui_trains_with_a_client_attached(tmp_path):
    from gs2mesh_torch.cli import gs_tools
    from tests.test_torch_core import look_at_camera
    from tests.test_torch_gs_tools_eval import write_scene

    src = tmp_path / "scene"
    write_scene(str(src), n=200, size=48)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cam = look_at_camera((0.0, 0.0, -3.0), 40, 24)
    result = {}
    client = threading.Thread(target=sibr_client, args=(
        port, [sibr_message(cam)] * 50, result))
    client.start()
    tr = gs_tools.gs_train(str(src), str(tmp_path / "model"), iterations=4,
                           test_iterations=(), save_iterations=(4,),
                           quiet=True, gui=True, port=port, device="cpu")
    client.join(timeout=60)
    assert tr.iteration == 4
    frames = result["frames"]
    assert 1 <= len(frames) <= 4
    for img, verify in frames:
        assert len(img) == 40 * 24 * 3 and verify == str(src)
    assert (tmp_path / "model" / "chkpnt4.pt").exists()

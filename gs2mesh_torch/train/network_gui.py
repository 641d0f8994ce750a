"""SIBR remote-viewer bridge: TCP server streaming live renders mid-training
(port of gs2mesh_tpu train/network_gui.py).

Protocol-compatible with the reference network_gui
(third_party/gaussian-splatting/gaussian_renderer/network_gui.py:26-85):
in, a 4-byte little-endian length and then that many bytes of JSON
(camera, settings); out, the frame's raw RGB bytes (H x W x 3, row-major)
and then a 4-byte little-endian length and the verify string — so the SIBR
gaussianviewer remote client works against the port's trainer unmodified.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from gs2mesh_torch.core.camera import Camera


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]   # the bound port (0 ->)

    def try_connect(self) -> None:
        if self.conn is not None:
            return
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _read(self) -> dict:
        assert self.conn is not None
        length = int.from_bytes(self.conn.recv(4), "little")
        payload = b""
        while len(payload) < length:
            chunk = self.conn.recv(length - len(payload))
            if not chunk:
                raise ConnectionError("SIBR client closed the connection")
            payload += chunk
        return json.loads(payload.decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        assert self.conn is not None
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self) -> Tuple[Optional[dict], Optional[bool], bool, float]:
        """Returns (camera_message | None, do_training, keep_alive,
        scaling_modifier); camera_message carries the raw matrices + dims
        with the SIBR->GS sign flips applied (network_gui.py:60-82)."""
        message = self._read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, False, 1.0
        view = np.asarray(message["view_matrix"],
                          np.float32).reshape(4, 4)
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        proj = np.asarray(message["view_projection_matrix"],
                          np.float32).reshape(4, 4)
        proj[:, 1] = -proj[:, 1]
        cam = dict(width=width, height=height,
                   fovx=message["fov_x"], fovy=message["fov_y"],
                   znear=message["z_near"], zfar=message["z_far"],
                   world_view=view, full_proj=proj)
        return (cam, bool(message["train"]), bool(message["keep_alive"]),
                float(message["scaling_modifier"]))

    def disconnect(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()


def camera_from_message(cam_msg: dict, device) -> Camera:
    """The Camera of a received camera message, on ``device``: the matrices
    as sent (after the sign flips), the centre from inv(world_view)[3, :3]."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        world_view=t(cam_msg["world_view"]),
        full_proj=t(cam_msg["full_proj"]),
        cam_center=t(np.linalg.inv(cam_msg["world_view"])[3, :3]),
        tan_fovx=t(math.tan(cam_msg["fovx"] * 0.5)),
        tan_fovy=t(math.tan(cam_msg["fovy"] * 0.5)),
        width=int(cam_msg["width"]), height=int(cam_msg["height"]))


def frame_bytes(image: torch.Tensor) -> bytes:
    """(3, H, W) float image -> the raw RGB bytes SIBR reads: clipped to
    [0, 1], times 255 truncated to uint8, (H, W, 3) row-major."""
    arr = image.detach().cpu().numpy()
    return memoryview((np.clip(arr, 0, 1) * 255).astype(np.uint8)
                      .transpose(1, 2, 0).copy()).tobytes()


def serve_step(gui: NetworkGUI, render_fn, iteration: int, total: int,
               source_path: str, device="cuda") -> bool:
    """One training-loop GUI poll (the try/except dance of train.py:52-66).

    render_fn(camera, scaling_modifier) -> (3, H, W) float image in [0,1].
    Any exception while serving drops the client. Returns
    keep_training_connected."""
    gui.try_connect()
    while gui.conn is not None:
        try:
            net_image_bytes = None
            cam_msg, do_training, keep_alive, scaling = gui.receive()
            if cam_msg is not None:
                with torch.no_grad():
                    image = render_fn(camera_from_message(cam_msg, device),
                                      scaling)
                net_image_bytes = frame_bytes(image)
            gui.send(net_image_bytes, source_path)
            if do_training and (iteration < total or not keep_alive):
                return True
        except Exception:
            gui.disconnect()
    return False

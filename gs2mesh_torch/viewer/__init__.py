"""Interactive Gaussian-splat viewer (browser-based), the port of
gs2mesh_tpu viewer/.

Counterpart of the reference's SIBR gaussian viewer
(third_party/gaussian-splatting/SIBR_viewers, an OpenGL desktop app):
every frame is rendered by the port's rasterizer on the card (kernels K1
and K2) and streamed as PNG to a zero-dependency browser UI (orbit / pan /
dolly). The training-time remote-view protocol peer lives separately in
gs2mesh_torch/train/network_gui.py (SIBR socket protocol).
"""

from gs2mesh_torch.viewer.server import (PairCapacityError, ViewerServer,
                                         orbit_camera, quantize)

__all__ = ["ViewerServer", "orbit_camera", "quantize", "PairCapacityError"]

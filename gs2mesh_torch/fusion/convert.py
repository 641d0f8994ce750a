"""A TSDF volume as numpy arrays and back: the state that crosses between the
JAX package and the port.

``volume_from_numpy`` takes the fields of a JAX ``TSDFVolume`` (``keys``,
``order``, ``tsdf``, ``weight``, ``color``, ``n_blocks``, ``overflow``) as
numpy arrays and builds the port's volume on ``device``; ``volume_to_numpy``
gives them back. Both are exact, so either package's extractor can run on
the other's fused volume.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gs2mesh_torch.fusion.tsdf import TSDFConfig, TSDFVolume

FIELDS = ("keys", "order", "tsdf", "weight", "color", "n_blocks", "overflow")


def volume_from_numpy(arrays: Mapping[str, np.ndarray], cfg: TSDFConfig,
                      device="cuda") -> TSDFVolume:
    C, V = cfg.block_capacity, cfg.block_size ** 3
    shapes = {"keys": (C,), "order": (C,), "tsdf": (C, V), "weight": (C, V),
              "color": (C, V, 3)}
    t = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape} for "
                             f"{cfg}")
        dtype = np.int32 if name in ("keys", "order") else np.float32
        t[name] = torch.tensor(np.asarray(a, dtype), device=device)
    return TSDFVolume(n_blocks=int(arrays["n_blocks"]),
                      overflow=bool(arrays["overflow"]), **t)


def volume_to_numpy(vol: TSDFVolume) -> dict:
    out = {name: getattr(vol, name).cpu().numpy()
           for name in ("keys", "order", "tsdf", "weight", "color")}
    out["n_blocks"] = np.int32(vol.n_blocks)
    out["overflow"] = np.bool_(vol.overflow)
    return out

"""GaussianModel: the 3DGS parameter store as tensors.

Port of the reference's raw parameters and activations
(gaussian-splatting scene/gaussian_model.py): ``xyz``, ``features_dc``,
``features_rest``, log ``scaling``, quaternion ``rotation`` (w, x, y, z) and
logit ``opacity``, with the same field layouts as the JAX package's
``GaussianParams`` so weights carry across (``params_from_numpy``), and PLY
save/load byte-compatible with the reference checkpoint format. Rows whose
``alive`` flag is false render with zero opacity and are not saved.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core import ply as plyio
from gs2mesh_torch.core.sh import num_sh_coeffs

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@dataclasses.dataclass
class GaussianParams:
    """Raw (pre-activation) parameters, one row per gaussian."""

    xyz: torch.Tensor            # (N, 3)
    features_dc: torch.Tensor    # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    scaling: torch.Tensor        # (N, 3) log-scale
    rotation: torch.Tensor       # (N, 4) unnormalized quaternion (w, x, y, z)
    opacity: torch.Tensor        # (N, 1) logit


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device="cuda") -> GaussianParams:
    """Arrays named and laid out as the JAX package's ``GaussianParams``
    leaves (e.g. ``features_dc`` (N, 1, 3)) -> float32 params on ``device``."""
    device = resolve_device(device)
    return GaussianParams(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in FIELDS})


@dataclasses.dataclass
class GaussianModel:
    params: GaussianParams
    max_sh_degree: int
    alive: Optional[torch.Tensor] = None   # (N,) bool; None = all alive

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    # Activations (gaussian_model.py:94-122).
    def act_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    def act_rotation(self) -> torch.Tensor:
        q = self.params.rotation
        return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)

    def act_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)[:, 0]

    def sh_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)

    def raster_inputs(self) -> dict:
        opacity = self.act_opacity()
        if self.alive is not None:
            opacity = torch.where(self.alive, opacity, 0.0)
        return dict(means3d=self.params.xyz, scales=self.act_scaling(),
                    rotations=self.act_rotation(), opacities=opacity,
                    shs=self.sh_features())

    # Checkpoint IO (format of gaussian_model.py:191-256).
    def save_ply(self, path: str) -> None:
        p = {k: getattr(self.params, k).detach().cpu().numpy() for k in FIELDS}
        n = p["xyz"].shape[0]
        sel = (np.arange(n) if self.alive is None
               else np.nonzero(self.alive.cpu().numpy())[0])
        xyz = p["xyz"][sel]
        # Features are stored transposed: (N, 3, K) flattened channel-major.
        f_dc = p["features_dc"][sel].transpose(0, 2, 1).reshape(len(sel), -1)
        f_rest = p["features_rest"][sel].transpose(0, 2, 1).reshape(
            len(sel), -1)
        zeros = np.zeros(len(sel), np.float32)
        verts = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                 "nx": zeros, "ny": zeros, "nz": zeros}
        for i in range(f_dc.shape[1]):
            verts[f"f_dc_{i}"] = f_dc[:, i]
        for i in range(f_rest.shape[1]):
            verts[f"f_rest_{i}"] = f_rest[:, i]
        verts["opacity"] = p["opacity"][sel, 0]
        for i in range(3):
            verts[f"scale_{i}"] = p["scaling"][sel, i]
        for i in range(4):
            verts[f"rot_{i}"] = p["rotation"][sel, i]
        plyio.write_ply(path, {k: np.ascontiguousarray(v, np.float32)
                               for k, v in verts.items()})

    @staticmethod
    def load_ply(path: str, max_sh_degree: int = 3,
                 device="cuda") -> "GaussianModel":
        v = plyio.read_ply(path).vertex
        n = len(v["x"])
        K = num_sh_coeffs(max_sh_degree)
        f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)[:, :, None]
        rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                            key=lambda s: int(s.split("_")[-1]))
        if len(rest_names) != 3 * (K - 1):
            raise ValueError(f"{path}: {len(rest_names)} f_rest properties, "
                             f"expected {3 * (K - 1)} for SH degree "
                             f"{max_sh_degree}")
        if rest_names:
            f_rest = np.stack([v[k] for k in rest_names],
                              axis=1).reshape(n, 3, K - 1)
        else:
            f_rest = np.zeros((n, 3, 0), np.float32)
        params = params_from_numpy(dict(
            xyz=np.stack([v["x"], v["y"], v["z"]], axis=1),
            features_dc=f_dc.transpose(0, 2, 1),
            features_rest=f_rest.transpose(0, 2, 1),
            scaling=np.stack([v[f"scale_{i}"] for i in range(3)], axis=1),
            rotation=np.stack([v[f"rot_{i}"] for i in range(4)], axis=1),
            opacity=v["opacity"][:, None]), device)
        return GaussianModel(params=params, max_sh_degree=max_sh_degree)

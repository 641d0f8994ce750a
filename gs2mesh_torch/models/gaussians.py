"""GaussianModel: the 3DGS parameter store as tensors padded to a capacity.

Port of gs2mesh_tpu models/gaussians.py (the reference
scene/gaussian_model.py): raw parameters ``xyz``, ``features_dc``,
``features_rest``, log ``scaling``, quaternion ``rotation`` (w, x, y, z)
and logit ``opacity`` with the same activations and field layouts as the
JAX package's ``GaussianParams`` (so weights carry across,
``params_from_numpy`` / ``state_from_numpy`` / ``adam_state_from_numpy``);
SfM point-cloud init; adaptive density control over a STATIC capacity with
an alive mask (new rows take the lowest dead slots, dead rows keep opacity
logit ``DEAD_LOGIT``), so densification is row-for-row comparable with the
JAX package; PLY save/load byte-compatible with the reference checkpoint
format (dead rows are not saved).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core import ply as plyio
from gs2mesh_torch.core.sh import num_sh_coeffs, rgb_to_sh_dc

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
STATE_FIELDS = ("alive", "max_radii2D", "xyz_grad_accum", "denom")
# Adam parameter-group name of each field (the JAX package's optax labels).
GROUP_OF = {"xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
            "scaling": "scaling", "rotation": "rotation",
            "opacity": "opacity"}
DEAD_LOGIT = -15.0  # sigmoid(-15) ~ 3e-7 < 1/255: dead rows never contribute


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianParams:
    """Raw (pre-activation) parameters, one row per gaussian slot."""

    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log-scale
    rotation: torch.Tensor       # (C, 4) unnormalized quaternion (w, x, y, z)
    opacity: torch.Tensor        # (C, 1) logit

    def tensors(self):
        return [getattr(self, f) for f in FIELDS]


@dataclasses.dataclass
class GaussianState:
    """Non-trainable per-slot state."""

    alive: torch.Tensor          # (C,) bool
    max_radii2D: torch.Tensor    # (C,) float32
    xyz_grad_accum: torch.Tensor  # (C,) accumulated NDC grad norms
    denom: torch.Tensor          # (C,) accumulation counts

    @staticmethod
    def fresh(alive: torch.Tensor) -> "GaussianState":
        def z():
            return torch.zeros(alive.shape, dtype=torch.float32,
                               device=alive.device)
        return GaussianState(alive=alive, max_radii2D=z(), xyz_grad_accum=z(),
                             denom=z())


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device="cuda") -> GaussianParams:
    """Arrays named and laid out as the JAX package's ``GaussianParams``
    leaves (e.g. ``features_dc`` (N, 1, 3)) -> float32 params on ``device``."""
    device = resolve_device(device)
    return GaussianParams(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in FIELDS})


def state_from_numpy(d: Mapping[str, np.ndarray],
                     device="cuda") -> GaussianState:
    """The JAX package's ``GaussianState`` leaves -> tensors on ``device``."""
    device = resolve_device(device)
    return GaussianState(
        alive=torch.tensor(np.asarray(d["alive"], bool), device=device),
        **{k: torch.tensor(np.asarray(d[k], np.float32), device=device)
           for k in STATE_FIELDS[1:]})


def adam_state_from_numpy(optimizer: torch.optim.Optimizer,
                          groups: Mapping[str, tuple]) -> None:
    """Sets the Adam moments of ``optimizer`` (built by
    ``train.trainer.make_optimizer``) from optax ``ScaleByAdamState``
    leaves: ``groups`` maps each group name (xyz, f_dc, f_rest, opacity,
    scaling, rotation) to (mu, nu, count)."""
    for group in optimizer.param_groups:
        (p,) = group["params"]
        mu, nu, count = groups[group["name"]]
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu, np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu, np.float32),
                                       device=p.device)}


def activations(params: GaussianParams, alive: Optional[torch.Tensor]):
    """Rasterizer inputs from raw params (gaussian_model.py:94-122); dead
    rows get opacity 0."""
    q = params.rotation
    opacity = torch.sigmoid(params.opacity)[:, 0]
    if alive is not None:
        opacity = torch.where(alive, opacity, 0.0)
    return dict(
        means3d=params.xyz, scales=torch.exp(params.scaling),
        rotations=q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                       + 1e-12),
        opacities=opacity,
        shs=torch.cat([params.features_dc, params.features_rest], dim=1))


def _round_capacity(n: int, granularity: int = 4096) -> int:
    return max(granularity, -(-n // granularity) * granularity)


def _padded(x: torch.Tensor, capacity: int, fill=0.0) -> torch.Tensor:
    pad = torch.full((capacity - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def pad_params(params: GaussianParams, capacity: int,
               identity_rotation: bool = True) -> GaussianParams:
    """Params padded with dead rows (scale log -10, opacity DEAD_LOGIT,
    identity or, as the JAX package's load_ply pads, zero rotation) up to
    ``capacity``."""
    n = params.xyz.shape[0]
    rot = _padded(params.rotation, capacity)
    if identity_rotation:
        rot[n:, 0] = 1.0
    return GaussianParams(
        xyz=_padded(params.xyz, capacity),
        features_dc=_padded(params.features_dc, capacity),
        features_rest=_padded(params.features_rest, capacity),
        scaling=_padded(params.scaling, capacity, -10.0),
        rotation=rot,
        opacity=_padded(params.opacity, capacity, DEAD_LOGIT))


def pad_state(state: GaussianState, capacity: int) -> GaussianState:
    return GaussianState(alive=_padded(state.alive, capacity, False),
                         **{k: _padded(getattr(state, k), capacity)
                            for k in STATE_FIELDS[1:]})


@dataclasses.dataclass
class GaussianModel:
    params: GaussianParams
    max_sh_degree: int
    state: Optional[GaussianState] = None   # None = every row alive
    active_sh_degree: int = 0
    spatial_lr_scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def alive(self) -> Optional[torch.Tensor]:
        return None if self.state is None else self.state.alive

    @alive.setter
    def alive(self, alive: torch.Tensor) -> None:
        if self.state is None:
            self.state = GaussianState.fresh(alive)
        else:
            self.state.alive = alive

    def num_alive(self) -> int:
        return self.capacity if self.state is None else int(
            self.state.alive.sum())

    def raster_inputs(self) -> dict:
        return activations(self.params, self.alive)

    @staticmethod
    def from_point_cloud(points: np.ndarray, colors: np.ndarray,
                         max_sh_degree: int = 3,
                         capacity: Optional[int] = None,
                         spatial_lr_scale: float = 1.0,
                         device="cuda") -> "GaussianModel":
        """Init from an SfM point cloud (gaussian_model.py:124-147): scale
        log sqrt(mean 3-NN squared distance), opacity 0.1, identity
        rotation, DC colour from ``colors`` in [0, 1]."""
        from gs2mesh_torch.ops.knn import mean_sq_dist_3nn

        device = resolve_device(device)
        n = points.shape[0]
        capacity = capacity or _round_capacity(n)
        K = num_sh_coeffs(max_sh_degree)
        pts = torch.tensor(np.asarray(points, np.float32), device=device)
        dist2 = torch.clamp_min(mean_sq_dist_3nn(pts), 1e-7)
        scales_log = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
        fdc = rgb_to_sh_dc(torch.tensor(np.asarray(colors, np.float32),
                                        device=device))[:, None, :]
        rot = torch.zeros((n, 4), dtype=torch.float32, device=device)
        rot[:, 0] = 1.0
        opa = inverse_sigmoid(torch.full((n, 1), 0.1, dtype=torch.float32,
                                         device=device))
        params = pad_params(GaussianParams(
            xyz=pts, features_dc=fdc,
            features_rest=torch.zeros((n, K - 1, 3), dtype=torch.float32,
                                      device=device),
            scaling=scales_log, rotation=rot, opacity=opa), capacity)
        alive = torch.arange(capacity, device=device) < n
        return GaussianModel(params=params, max_sh_degree=max_sh_degree,
                             state=GaussianState.fresh(alive),
                             spatial_lr_scale=spatial_lr_scale)

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
                 capacity: Optional[int] = None,
                 device="cuda") -> "GaussianModel":
        """Rows in file order; with ``capacity``, padded with dead rows."""
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
        state = None
        if capacity is not None:
            if capacity < n:
                raise ValueError(f"{path}: {n} rows exceed capacity "
                                 f"{capacity}")
            params = pad_params(params, capacity, identity_rotation=False)
            state = GaussianState.fresh(
                torch.arange(capacity, device=params.xyz.device) < n)
        return GaussianModel(params=params, max_sh_degree=max_sh_degree,
                             state=state, active_sh_degree=max_sh_degree)


# ---------------------------------------------------------------------------
# Densification over a static capacity
# ---------------------------------------------------------------------------

class DensifyConfig(NamedTuple):
    grad_threshold: float = 0.0002      # densify_grad_threshold
    percent_dense: float = 0.01         # fraction of scene extent
    opacity_cull: float = 0.005         # min_opacity for pruning
    split_scale_div: float = 1.6        # scale shrink for split children
    max_screen_size: float = 0.0        # > 0: the size prune (size_threshold)


def accumulate_densification_stats(state: GaussianState, screenspace_grad,
                                   radii, width: int,
                                   height: int) -> GaussianState:
    """Grad-norm accumulators of visible gaussians (gaussian_model.py:405-407
    + train.py:116-117). screenspace_grad is dL/dmeans2d in PIXEL units;
    it is rescaled to the NDC units the reference thresholds were tuned for
    (backward.cu ddelx_dx = 0.5 * W)."""
    vis = radii > 0
    scale = torch.tensor([[0.5 * width, 0.5 * height]], dtype=torch.float32,
                         device=screenspace_grad.device)
    norm = torch.linalg.vector_norm(screenspace_grad * scale, dim=-1)
    return GaussianState(
        alive=state.alive,
        xyz_grad_accum=state.xyz_grad_accum + torch.where(vis, norm, 0.0),
        denom=state.denom + torch.where(vis, 1.0, 0.0),
        max_radii2D=torch.maximum(
            state.max_radii2D,
            torch.where(vis, radii.to(torch.float32), 0.0)))


def zero_opt_rows(optimizer: Optional[torch.optim.Optimizer],
                  dirty: torch.Tensor) -> None:
    """Zero the Adam moments of the ``dirty`` rows of every group (the
    reference rebuilds optimizer tensors with zeros for new rows,
    gaussian_model.py:258-327); the step counts are kept."""
    if optimizer is None:
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, m in optimizer.state.get(p, {}).items():
                if key != "step":
                    m.masked_fill_(dirty.reshape((-1,) + (1,) * (m.ndim - 1)),
                                   0.0)


@torch.no_grad()
def densify_and_prune(params: GaussianParams, state: GaussianState,
                      optimizer: Optional[torch.optim.Optimizer],
                      scene_extent: float, cfg: DensifyConfig,
                      generator: torch.Generator):
    """Clone / split / prune within the capacity, with the split samples
    drawn from ``generator``; see densify_and_prune_draws."""
    C = params.xyz.shape[0]
    z1 = torch.randn((C, 3), generator=generator, device=params.xyz.device)
    z2 = torch.randn((C, 3), generator=generator, device=params.xyz.device)
    return densify_and_prune_draws(params, state, optimizer, scene_extent,
                                   cfg, z1, z2)


@torch.no_grad()
def densify_and_prune_draws(params: GaussianParams, state: GaussianState,
                            optimizer: Optional[torch.optim.Optimizer],
                            scene_extent: float, cfg: DensifyConfig,
                            z1: torch.Tensor, z2: torch.Tensor):
    """densify_and_clone + densify_and_split + prune
    (gaussian_model.py:349-403) with the two (C, 3) standard-normal draws
    given:
      clone: grad >= thr and max(scale) <= percent_dense * extent: copied;
      split: grad >= thr and larger: the parent is resampled in place
             (draw z1) and one new row takes the second sample (z2), both
             at scale / 1.6;
      prune: opacity < cull, or (with ``max_screen_size`` > 0) a world
             size over a tenth of the scene extent.
    The reference's densification_postfix sets max_radii2D to zeros for
    every row, and both its clone and its split pass call it before
    prune_points, so its screen-size test (``big_points_vs``) sees zeros
    and never prunes: here too max_radii2D is zeroed for every row before
    the prune and stays zero in the returned state. (The JAX package keeps
    each alive row's radii and prunes rows ever over ``max_screen_size``.)
    New rows take the lowest-index dead slots; candidates past the dead
    slots are dropped (``overflow``). The Adam moments of new, pruned and
    split rows are zeroed in ``optimizer``. Returns (params, state, stats).
    """
    from gs2mesh_torch.ops.rasterizer.preprocess import quat_to_rotmat

    C = params.xyz.shape[0]
    alive = state.alive
    grads = torch.where(state.denom > 0, state.xyz_grad_accum / state.denom,
                        0.0)
    scales = torch.exp(params.scaling)
    max_scale = scales.max(dim=1).values
    opacity = torch.sigmoid(params.opacity[:, 0])

    prune = alive & (opacity < cfg.opacity_cull)
    if cfg.max_screen_size > 0:
        # The screen-size test of the zeroed radii prunes nothing.
        prune = prune | (alive & (max_scale > 0.1 * scene_extent))
    keep = alive & ~prune

    wants = keep & (grads >= cfg.grad_threshold)
    small = max_scale <= cfg.percent_dense * scene_extent
    clone = wants & small
    split = wants & ~small
    new_needed = clone | split

    # New rows go to dead slots (freshly pruned included) in index order.
    dead = ~keep
    dead_slots = torch.nonzero(dead)[:, 0]
    cand_rank = torch.cumsum(new_needed.to(torch.int64), 0) - 1
    n_dead = dead_slots.shape[0]
    granted = new_needed & (cand_rank < n_dead)
    src = torch.nonzero(granted)[:, 0]            # candidate rows, in order
    dst = dead_slots[cand_rank[src]]              # their slots

    rot = params.rotation / (torch.linalg.vector_norm(
        params.rotation, dim=-1, keepdim=True) + 1e-12)
    R = quat_to_rotmat(rot)                                 # (C, 3, 3)
    child1 = params.xyz + torch.einsum("nij,nj->ni", R, z1 * scales)
    child2 = params.xyz + torch.einsum("nij,nj->ni", R, z2 * scales)
    child_scaling = torch.log(scales / cfg.split_scale_div)
    sp = split[:, None]
    # Rows written into granted slots: clones copy, splits take child 2.
    src_xyz = torch.where(sp, child2, params.xyz)
    xyz = torch.where(sp, child1, params.xyz)
    scaling = torch.where(sp, child_scaling, params.scaling)

    def scatter_new(rows, new_rows):
        out = rows.clone()
        out[dst] = new_rows[src]
        return out

    new_alive = keep.clone()
    new_alive[dst] = True
    params = GaussianParams(
        xyz=scatter_new(xyz, src_xyz),
        features_dc=scatter_new(params.features_dc, params.features_dc),
        features_rest=scatter_new(params.features_rest,
                                  params.features_rest),
        scaling=scatter_new(scaling, scaling),
        rotation=scatter_new(params.rotation, params.rotation),
        opacity=torch.where(new_alive[:, None],
                            scatter_new(params.opacity, params.opacity),
                            DEAD_LOGIT))
    dirty = (~new_alive) | split
    dirty[dst] = True
    zero_opt_rows(optimizer, dirty)

    zeros = torch.zeros((C,), dtype=torch.float32, device=alive.device)
    state = GaussianState(alive=new_alive, max_radii2D=zeros.clone(),
                          xyz_grad_accum=zeros, denom=zeros.clone())
    n_clone, n_split, n_prune, n_new = torch.stack(
        [clone.sum(), split.sum(), prune.sum(), new_needed.sum()]).tolist()
    stats = dict(n_clone=n_clone, n_split=n_split, n_prune=n_prune,
                 n_new=n_new, n_granted=int(src.shape[0]),
                 overflow=n_new > n_dead)
    return params, state, stats


@torch.no_grad()
def reset_opacity(params: GaussianParams, alive) -> GaussianParams:
    """Clamp opacity to <= 0.01 (gaussian_model.py:210-213)."""
    new = inverse_sigmoid(torch.clamp_max(torch.sigmoid(params.opacity),
                                          0.01))
    return dataclasses.replace(
        params, opacity=torch.where(alive[:, None], new, DEAD_LOGIT))

"""GS training: the train step and the host-side densification loop.

Port of gs2mesh_tpu train/trainer.py (the reference train.py:31-132):

  * the step: render -> (1 - l) L1 + l (1 - SSIM) -> backward (kernels K3
    and K4 on the card, then autograd through preprocess and the
    activations) -> densification stats from the screen-space probe ->
    dead-row gradients zeroed -> per-group ``torch.optim.Adam`` (eps 1e-15,
    the LRs of gaussian_model.py:154-167, the exponential xyz schedule);
  * a render that overflows ``pair_capacity`` (or the plain compositor's
    per-tile bound) takes no step: no Adam update, no stats update; the
    host loop grows the bound and redoes the same view (the JAX package's
    no-op gate, trainer.py:185-200 and :277-286);
  * host cadence: densify / prune every ``densification_interval``
    iterations in [densify_from, densify_until], opacity reset every
    ``opacity_reset_interval``, SH degree bump every 1000 iterations;
  * checkpoints: the GS PLY plus ``torch.save`` of the Adam state and the
    per-row state, rows permuted into the PLY's compacted order.

Parameters are updated in place (their tensors keep their identity, so
the optimizer's groups stay bound to them); densification and capacity
growth replace each tensor's data.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.camera import Camera
from gs2mesh_torch.models.gaussians import (FIELDS, GROUP_OF, DensifyConfig,
                                            GaussianModel, GaussianParams,
                                            GaussianState,
                                            accumulate_densification_stats,
                                            activations, densify_and_prune,
                                            pad_params, pad_state,
                                            reset_opacity)
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.ops.ssim import gs_loss, psnr

PAIR_CAPACITY_MAX = 1 << 30     # emission slots and ids are 32-bit
# The train step's profiler ranges, "train_step.<stage>", in step order.
STEP_STAGES = ("forward", "loss", "overflow_gate", "backward",
               "densify_stats", "optimizer")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """OptimizationParams parity (arguments/__init__.py:71-89)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    white_background: bool = False
    sh_degree: int = 3
    random_background: bool = False


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear LR interpolation with an optional delay (the Plenoxels
    schedule the reference uses for xyz)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp


def xyz_lr(cfg: TrainConfig, spatial_lr_scale: float, step: int) -> float:
    return expon_lr(step, cfg.position_lr_init * spatial_lr_scale,
                    cfg.position_lr_final * spatial_lr_scale,
                    lr_delay_steps=0, lr_delay_mult=cfg.position_lr_delay_mult,
                    max_steps=cfg.position_lr_max_steps)


def make_optimizer(params: GaussianParams, cfg: TrainConfig,
                   spatial_lr_scale: float) -> torch.optim.Adam:
    """Per-group Adam (eps 1e-15) with the reference's LRs; each group is
    named as the JAX package's optax labels, and holds one field."""
    lrs = {"xyz": xyz_lr(cfg, spatial_lr_scale, 0), "f_dc": cfg.feature_lr,
           "f_rest": cfg.feature_lr / 20.0, "opacity": cfg.opacity_lr,
           "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr}
    return torch.optim.Adam(
        [{"params": [getattr(params, f)], "lr": lrs[GROUP_OF[f]],
          "name": GROUP_OF[f]} for f in FIELDS], lr=0.0, eps=1e-15)


def optimizer_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates taken so far (every group steps together)."""
    p = optimizer.param_groups[0]["params"][0]
    st = optimizer.state.get(p)
    return int(st["step"]) if st else 0


class StepOutput(NamedTuple):
    loss: torch.Tensor
    radii: torch.Tensor
    num_pairs: torch.Tensor
    overflow: bool               # pair_capacity exceeded: no step taken
    tile_overflow: bool          # plain per-tile bound exceeded: no step
    grads: Optional[Dict[str, torch.Tensor]]   # applied gradients, or None


def render_model(params: GaussianParams, alive, camera: Camera,
                 active_sh_degree: int, bg, rcfg: RasterizerConfig,
                 screenspace_offset=None, max_per_tile: int = 4096,
                 scale_modifier: float = 1.0):
    """Render the current parameters through ``camera``."""
    inp = activations(params, alive)
    return rasterize(inp["means3d"], inp["scales"], inp["rotations"],
                     inp["opacities"], inp["shs"], camera, active_sh_degree,
                     bg=bg, cfg=rcfg, scale_modifier=scale_modifier,
                     screenspace_offset=screenspace_offset,
                     max_per_tile=max_per_tile)


def train_step(model: GaussianModel, optimizer: torch.optim.Optimizer,
               camera: Camera, target: torch.Tensor, bg: torch.Tensor,
               cfg: TrainConfig, rcfg: RasterizerConfig,
               active_sh_degree: int, max_per_tile: int = 4096) -> StepOutput:
    """One step on one view; updates model.params (in place), model.state
    and the optimizer unless the render overflowed. Each stage runs in a
    profiler range "train_step.<stage>" (STEP_STAGES)."""
    params = model.params
    leaves = params.tensors()
    with record_function("train_step.forward"):
        offs = torch.zeros((model.capacity, 2), dtype=torch.float32,
                           device=model.device, requires_grad=True)
        out = render_model(params, model.state.alive, camera,
                           active_sh_degree, bg, rcfg,
                           screenspace_offset=offs, max_per_tile=max_per_tile)
    with record_function("train_step.loss"):
        loss = gs_loss(out.image, target, cfg.lambda_dssim)
    with record_function("train_step.overflow_gate"):
        overflow, tile_overflow = (
            bool(v) for v in torch.stack([out.overflow, out.tile_overflow]))
    if overflow or tile_overflow:
        # Gradients of a truncated render are never applied.
        return StepOutput(loss.detach(), out.radii, out.num_pairs, overflow,
                          tile_overflow, None)
    with record_function("train_step.backward"):
        *grads, ss_grad = torch.autograd.grad(loss, leaves + [offs],
                                              allow_unused=True)
    with record_function("train_step.densify_stats"):
        model.state = accumulate_densification_stats(
            model.state, ss_grad, out.radii, camera.width, camera.height)
    with record_function("train_step.optimizer"):
        # Dead padded rows can get NaN gradients (d/dq of the quaternion
        # normalization); zero them so dead rows and their moments stay at
        # their fill values.
        alive = model.state.alive
        applied = {}
        for f, leaf, g in zip(FIELDS, leaves, grads):
            g = torch.zeros_like(leaf) if g is None else g
            leaf.grad = torch.where(
                alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
            applied[f] = leaf.grad
        # optax's scale_by_schedule reads the count before its increment.
        optimizer.param_groups[0]["lr"] = xyz_lr(
            cfg, model.spatial_lr_scale, optimizer_step_count(optimizer))
        optimizer.step()
        for leaf in leaves:
            leaf.grad = None
    return StepOutput(loss.detach(), out.radii, out.num_pairs, False, False,
                      applied)


@dataclasses.dataclass
class Trainer:
    """Host-side GS training loop over a list of (Camera, image) views.
    The model and the cameras must be on ``device``.

    The loop's policy (view order, grow-and-redo, densify / opacity-reset
    cadence, checkpoints) is shared with ``parallel.ShardedTrainer``, which
    overrides the hooks that touch the rows: ``_step``, ``_whole`` /
    ``_set_whole`` (the whole model and an optimizer over it, and back),
    ``_load_whole`` and ``save_checkpoint``."""

    model: GaussianModel
    cameras: Sequence[Camera]
    images: Sequence[np.ndarray]          # (3, H, W) float arrays in [0, 1]
    cfg: TrainConfig = TrainConfig()
    rcfg: RasterizerConfig = RasterizerConfig()
    max_per_tile: int = 4096
    scene_extent: float = 1.0
    seed: int = 0
    device: str = "cuda"

    log_tag = "train"
    views_per_step = 1

    def __post_init__(self):
        # With its index filled in ("cuda" -> "cuda:0"), as tensors report it.
        self.device = torch.empty(0, device=resolve_device(self.device)).device
        if self.model.device != self.device:
            raise ValueError(f"model on {self.model.device}, trainer on "
                             f"{self.device}")
        # Float32 products of the loss stay float32 on the card (TF32
        # keeps about 3 digits).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.model.state is None:
            self.model.alive = torch.ones(self.model.capacity,
                                          dtype=torch.bool,
                                          device=self.device)
        self._new_optimizer()
        self.iteration = 0
        self._rng = np.random.default_rng(self.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._view_stack: List[int] = []
        self._images_dev: Dict[int, torch.Tensor] = {}
        self.history: List[Dict[str, float]] = []

    def _new_optimizer(self):
        for leaf in self.model.params.tensors():
            leaf.requires_grad_(True)
        self.optimizer = make_optimizer(self.model.params, self.cfg,
                                        self.model.spatial_lr_scale)

    @property
    def capacity(self) -> int:
        """Rows of the whole model."""
        return self.model.capacity

    def num_alive(self) -> int:
        return self.model.num_alive()

    def _bg(self) -> torch.Tensor:
        if self.cfg.random_background:
            return torch.rand(3, generator=self._gen, device=self.device)
        return torch.full((3,), 1.0 if self.cfg.white_background else 0.0,
                          dtype=torch.float32, device=self.device)

    def _next_views(self) -> List[int]:
        out = []
        for _ in range(self.views_per_step):
            if not self._view_stack:
                self._view_stack = list(range(len(self.cameras)))
                self._rng.shuffle(self._view_stack)
            out.append(self._view_stack.pop())
        return out

    def _image_dev(self, vi: int) -> torch.Tensor:
        """Targets stay on the device after their first use."""
        if vi not in self._images_dev:
            self._images_dev[vi] = torch.tensor(
                np.asarray(self.images[vi], np.float32), device=self.device)
        return self._images_dev[vi]

    def _step(self, views: List[int], sh_degree: int):
        (vi,) = views
        return train_step(self.model, self.optimizer, self.cameras[vi],
                          self._image_dev(vi), self._bg(), self.cfg,
                          self.rcfg, sh_degree, self.max_per_tile)

    def train(self, iterations: Optional[int] = None, log_every: int = 0,
              callback=None):
        cfg = self.cfg
        total = iterations if iterations is not None else cfg.iterations
        end = self.iteration + total
        while self.iteration < end:
            self.iteration += 1
            it = self.iteration
            # SH degree warm-up: one band more every 1000 iterations.
            sh_deg = min(it // 1000, cfg.sh_degree)
            views = self._next_views()
            out = self._step(views, sh_deg)
            self.model.active_sh_degree = sh_deg
            # An overflowed render took no step: grow the bound that
            # overflowed and redo this iteration on the same views.
            if out.overflow or out.tile_overflow:
                if out.overflow:
                    self.grow_pair_capacity()
                if out.tile_overflow:
                    self.max_per_tile *= 2
                    print(f"[{self.log_tag}] max_per_tile -> "
                          f"{self.max_per_tile}")
                self._view_stack.extend(reversed(views))
                self.iteration -= 1
                continue

            if (cfg.densify_from_iter <= it <= cfg.densify_until_iter
                    and it % cfg.densification_interval == 0):
                self.densify()
            if it % cfg.opacity_reset_interval == 0 and it < cfg.iterations:
                self.reset_opacity()
            if log_every and it % log_every == 0:
                rec = dict(iteration=it, loss=float(out.loss),
                           num_alive=self.num_alive(),
                           num_pairs=out.num_pairs.tolist())
                self.history.append(rec)
                print(f"[{self.log_tag}] it={it} loss={rec['loss']:.5f} "
                      f"alive={rec['num_alive']} pairs={rec['num_pairs']}")
            if callback is not None:
                callback(self, out)
        return self

    # ------------------------------------------------------------------
    # The whole model (hooks ShardedTrainer overrides)
    # ------------------------------------------------------------------
    def _whole(self):
        """(the whole model, an optimizer over its params)."""
        return self.model, self.optimizer

    def _set_whole(self, params: GaussianParams, state: GaussianState,
                   optimizer) -> None:
        """New rows of the whole model from ``params`` / ``state`` and
        ``optimizer``'s moments (for this trainer, its own optimizer: new
        row values keep the tensors it holds)."""
        for leaf, new in zip(self.model.params.tensors(), params.tensors()):
            leaf.data = new.detach()
        self.model.state = state

    def _load_whole(self, model: GaussianModel, moments: dict) -> None:
        """Take ``model`` (the whole model) and Adam ``moments`` (group
        name -> state dict), with a fresh optimizer."""
        self.model = model
        self._new_optimizer()
        self._set_moments(moments)

    def _set_moments(self, moments: dict, rows=slice(None)) -> None:
        for g in self.optimizer.param_groups:
            st = moments.get(g["name"])
            if st:
                self.optimizer.state[g["params"][0]] = {
                    k: v if k == "step" else v[rows].clone()
                    for k, v in st.items()}

    # ------------------------------------------------------------------
    # Adaptive density control
    # ------------------------------------------------------------------
    def densify(self):
        # The size prune activates after an opacity reset (train.py:120);
        # as in the reference, only its world-size test can prune.
        big = 20.0 if self.iteration > self.cfg.opacity_reset_interval else 0.0
        dcfg = DensifyConfig(
            grad_threshold=self.cfg.densify_grad_threshold,
            percent_dense=self.cfg.percent_dense,
            opacity_cull=0.005, max_screen_size=big)
        model, optimizer = self._whole()
        params, state, stats = densify_and_prune(
            model.params, model.state, optimizer, self.scene_extent, dcfg,
            self._gen)
        self._set_whole(params, state, optimizer)
        # Out of dead slots, or the pool nearly full: double the capacity.
        if stats["overflow"] or int(state.alive.sum()) > 0.9 * self.capacity:
            self.grow_capacity(self.capacity * 2)
        return stats

    def grow_pair_capacity(self):
        """Double the rasterizer pair capacity after an emission overflow
        (the reference reallocates its binning buffers on demand,
        rasterizer_impl.cu:155-194)."""
        cap = self.rcfg.pair_capacity
        new = min(cap * 2, PAIR_CAPACITY_MAX)
        if new <= cap:
            raise RuntimeError(f"pair_capacity {cap} is at its bound; reduce "
                               "the image resolution or gaussian count")
        self.rcfg = dataclasses.replace(self.rcfg, pair_capacity=new)
        print(f"[{self.log_tag}] pair_capacity {cap} -> {new}")

    def grow_capacity(self, new_capacity: int):
        """Pad params, state and Adam moments with dead rows up to
        ``new_capacity`` (the step counts are kept)."""
        old = self.capacity
        if new_capacity <= old:
            return
        model, optimizer = self._whole()
        params, state = grow_rows(model.params, model.state, optimizer,
                                  new_capacity)
        self._set_whole(params, state, optimizer)
        print(f"[{self.log_tag}] capacity {old} -> {new_capacity} "
              f"(alive {int(state.alive.sum())})")

    def reset_opacity(self):
        """Row-wise, so a sharded trainer resets its own rows."""
        new = reset_opacity(self.model.params, self.model.state.alive)
        self.model.params.opacity.data = new.opacity.detach()
        # The reference's replace_tensor_to_optimizer: fresh moments for
        # the opacity group only.
        _zero_opacity_moments(self.optimizer)

    # ------------------------------------------------------------------
    # Evaluation / checkpointing
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, index: int, sh_degree: Optional[int] = None):
        return render_model(
            self.model.params, self.model.state.alive, self.cameras[index],
            self.model.active_sh_degree if sh_degree is None else sh_degree,
            self._bg(), self.rcfg, max_per_tile=self.max_per_tile)

    def report_psnr(self, indices: Optional[Sequence[int]] = None) -> float:
        idxs = list(indices) if indices is not None else range(
            len(self.cameras))
        return float(np.mean([
            float(psnr(self.render_view(i).image, self._image_dev(i)))
            for i in idxs]))

    def _checkpoint_bounds(self) -> dict:
        return dict(pair_capacity=self.rcfg.pair_capacity,
                    max_per_tile=self.max_per_tile)

    def save_checkpoint(self, path_dir: str):
        model, optimizer = self._whole()
        write_checkpoint(path_dir, model, optimizer, self.iteration,
                         **self._checkpoint_bounds())

    def restore_checkpoint(self, path_dir: str, iteration: int):
        """The saved rows fix the capacity (it may differ from this one's);
        the xyz schedule scales with spatial_lr_scale, so the optimizer is
        a fresh one holding the saved moments."""
        model, moments, blob = read_checkpoint(
            path_dir, iteration, self.model.max_sh_degree, self.device)
        self._load_whole(model, moments)
        self.iteration = blob["iteration"]
        self.rcfg = dataclasses.replace(self.rcfg, pair_capacity=blob.get(
            "pair_capacity", self.rcfg.pair_capacity))
        self.max_per_tile = blob.get("max_per_tile", self.max_per_tile)


def write_checkpoint(path_dir: str, model: GaussianModel, optimizer,
                     iteration: int, **extra) -> None:
    """The GS PLY of ``model`` at point_cloud/iteration_N/ and
    chkpntN.pt (Adam moments by group name, per-row state, SH degree,
    spatial LR scale, and ``extra``). ``optimizer`` needs only
    ``param_groups`` (one named parameter each) and ``state``."""
    os.makedirs(path_dir, exist_ok=True)
    model.save_ply(os.path.join(path_dir, "point_cloud",
                                f"iteration_{iteration}", "point_cloud.ply"))
    # save_ply keeps alive rows only, in order; the per-row state and Adam
    # moments go into the same order, dead rows after them, so a restored
    # row i and its moments describe the same gaussian.
    order = compact_row_order(model.state.alive)
    torch.save({
        "iteration": iteration,
        "opt_state": {g["name"]: permute_rows(
            optimizer.state.get(g["params"][0], {}), order)
            for g in optimizer.param_groups},
        "state": permute_rows(dataclasses.asdict(model.state), order),
        "active_sh_degree": model.active_sh_degree,
        "spatial_lr_scale": model.spatial_lr_scale, **extra,
    }, os.path.join(path_dir, f"chkpnt{iteration}.pt"))


def read_checkpoint(path_dir: str, iteration: int, max_sh_degree: int,
                    device) -> tuple:
    """write_checkpoint's files -> (GaussianModel with its per-row state,
    SH degree and spatial LR scale; Adam moments by group name; the blob)."""
    blob = torch.load(os.path.join(path_dir, f"chkpnt{iteration}.pt"),
                      map_location="cpu", weights_only=True)
    cap = blob["state"]["alive"].shape[0]
    ply = os.path.join(path_dir, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    model = GaussianModel.load_ply(ply, max_sh_degree, capacity=cap,
                                   device=device)
    model.state = GaussianState(**{k: v.to(device)
                                   for k, v in blob["state"].items()})
    model.active_sh_degree = blob["active_sh_degree"]
    model.spatial_lr_scale = blob["spatial_lr_scale"]
    moments = {name: {k: v if k == "step" else v.to(device)
                      for k, v in st.items()}
               for name, st in blob["opt_state"].items() if st}
    return model, moments, blob


def compact_row_order(alive: torch.Tensor) -> torch.Tensor:
    """(C,) permutation putting alive rows first (the checkpoint layout of
    save_ply / load_ply)."""
    alive = alive.cpu()
    return torch.cat([torch.nonzero(alive)[:, 0],
                      torch.nonzero(~alive)[:, 0]])


def permute_rows(tree: dict, order: torch.Tensor) -> dict:
    """Copy a dict of tensors to the host, permuting every capacity-row
    tensor by ``order``."""
    return {k: v.detach().cpu()[order]
            if v.ndim >= 1 and v.shape[0] == order.shape[0]
            else v.detach().cpu() for k, v in tree.items()}


def grow_rows(params: GaussianParams, state: GaussianState,
              optimizer: Optional[torch.optim.Optimizer], new_capacity: int):
    """Params and state padded with dead rows to ``new_capacity``; the Adam
    moments of ``optimizer`` are padded with zero rows in place."""
    old = params.xyz.shape[0]
    if new_capacity <= old:
        raise ValueError(f"capacity {new_capacity} <= {old}")
    if optimizer is not None:
        for group in optimizer.param_groups:
            st = optimizer.state.get(group["params"][0], {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    pad = torch.zeros((new_capacity - old,) + st[k].shape[1:],
                                      dtype=st[k].dtype, device=st[k].device)
                    st[k] = torch.cat([st[k], pad])
    return (pad_params(GaussianParams(*[t.detach() for t in params.tensors()]),
                       new_capacity),
            pad_state(state, new_capacity))


def _zero_opacity_moments(optimizer: torch.optim.Optimizer) -> None:
    """Zero the opacity group's Adam moments after an opacity reset
    (replace_tensor_to_optimizer, gaussian_model.py:258-273)."""
    for group in optimizer.param_groups:
        if group["name"] == "opacity":
            st = optimizer.state.get(group["params"][0], {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k].zero_()

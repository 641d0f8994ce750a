"""Static configuration for the tile rasterizer."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Rasterizer parameters.

    The port implements the reference's EXACT-CARRY semantics only: the
    JAX package's ``RasterizerConfig(feat_carry_bf16=False,
    grad_carry_bf16=False)``, always with a stable (tile, depth) sort. The
    JAX package's bf16 / minifloat payload packing, gaussian ids stuffed
    into mantissa bits, ``sort_stable=False`` and ``force_pallas`` exist
    for the TPU's sort and layout and are not ported. Its ``row_stride``
    (the sharded step's strided tile rows) is the ``row_stride`` argument
    of the emission and compositing functions here, beside ``row_offset``.
    """

    tile: int = 32                  # pixel tile edge; the CUDA compositors
                                    # run 256-thread blocks (K2 one per 16x16
                                    # quarter of a tile, a thread a pixel; K3
                                    # one per tile, a thread 4 pixels) and
                                    # stage 64 pairs per batch
    pair_capacity: int = 1 << 20    # max (tile, gaussian) pairs per frame
    # Numerical-semantics constants (identical to the CUDA reference):
    alpha_clamp: float = 0.99       # max per-gaussian alpha (forward.cu:346)
    alpha_min: float = 1.0 / 255.0  # skip threshold (forward.cu:347)
    transmittance_eps: float = 1e-4  # early-stop threshold (forward.cu:349)
    near: float = 0.2               # near-cull view-space z (auxiliary.h:154)
    dilation: float = 0.3           # low-pass cov2d dilation (forward.cu:110)
    fov_clamp: float = 1.3          # EWA tangent-plane clamp (forward.cu:86)

    @property
    def pixels_per_tile(self) -> int:
        return self.tile * self.tile

    def grid_size(self, width: int, height: int):
        gx = -(-width // self.tile)
        gy = -(-height // self.tile)
        return gx, gy

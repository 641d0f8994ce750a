"""The port's SAM2-large image encoder (Hiera trunk + FPN neck) against the
JAX package's, on the CPU.

The large preset's own path: window spec (8, 4, 16, 8), global attention
at blocks 23, 33 and 43, 36 blocks in stage 3, and the window pos-embed
tiled over the bicubic background. At image size 512 every stage's grid
(128, 64, 32, 16) holds whole windows of the preset's sizes, as at the
released 1024, with a quarter of the tokens. Weights: the encoder's leaves
drawn from a seeded ``torch.Generator`` (biases, norms and the pos embeds
away from their initial values), carried to JAX by the JAX package's
``convert_sam2_state_dict``. Tolerance: each output within 1e-5 of its
largest magnitude, as tests/test_torch_sam2.py holds tiny.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gs2mesh_tpu.sam2 import SAM2Config as JConfig
from gs2mesh_tpu.sam2 import convert as jconvert
from gs2mesh_tpu.sam2 import hiera as jhiera
from gs2mesh_torch.sam2 import SAM2Config
from gs2mesh_torch.sam2 import hiera

IMG = 512
TOL = 1e-5


def seeded_encoder(cfg, seed=0):
    """SAM2-large's ImageEncoder with every leaf drawn from ``seed``:
    weights N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.1^2), the pos embeds N(0, 0.5^2)."""
    enc = hiera.ImageEncoder(cfg.hiera, cfg.backbone_channel_list)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if "pos_embed" in name:
                p.copy_(0.5 * noise)
            elif name.endswith("weight") and p.ndim >= 2:
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)
    return enc.eval()


def close(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"relative gap {err:.3e} > {TOL}"


def test_large_hiera_and_neck():
    cfg, jcfg = SAM2Config.large(IMG), JConfig.large(image_size=IMG)
    assert cfg.hiera.window_spec == (8, 4, 16, 8)
    assert cfg.hiera.global_att_blocks == (23, 33, 43)
    enc = seeded_encoder(cfg)
    jparams = jconvert.convert_sam2_state_dict(
        {f"image_encoder.{k}": v for k, v in enc.state_dict().items()}
    )["image_encoder"]
    x = np.random.default_rng(3).normal(size=(1, IMG, IMG, 3)).astype(
        np.float32)
    grid = IMG // 4
    jouts = jax.jit(lambda p, i: jhiera.hiera_forward(i, p, jcfg.hiera))(
        jparams["trunk"], jnp.asarray(x))
    with torch.no_grad():
        close(hiera.hiera_pos_embed(enc.trunk, grid, grid),
              jhiera.hiera_pos_embed(jparams["trunk"], jcfg.hiera, grid,
                                     grid))
        pouts = hiera.hiera_forward(torch.from_numpy(x), enc.trunk)
        assert [o.shape[1] for o in pouts] == [128, 64, 32, 16]
        for p_, j_ in zip(pouts, jouts):
            close(p_, j_)
        pf, pp = hiera.fpn_neck_forward(pouts, enc.neck)
    jf, jp = jhiera.fpn_neck_forward(jouts, jparams["neck"], 256, 4)
    for a, b in zip(pf + pp, jf + jp):
        close(a, b)

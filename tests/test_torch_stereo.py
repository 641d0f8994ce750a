"""The port's DLNR (gs2mesh_torch.stereo) against the JAX package's, module by
module and whole, on the CPU.

Weights: the port's seeded init with every leaf then perturbed (ParamMaker
alone gives zero biases and identity norms, which would leave those
conversions unexercised), carried to JAX by the JAX package's own
``convert_torch_state_dict``, which also proves the state-dict names are the
reference's. Inputs come from numpy seeds at the JAX tests' sizes (64x96, 2
iterations). Tolerances: each module's output within 1e-5 of its largest
magnitude; the whole forward within 1e-4 of the largest |disparity|, or
within 4x JAX's own float32 error against the port's float64 forward where
that is larger (``forward_limit``: this random-weight net amplifies float32
rounding several hundredfold in two iterations).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gs2mesh_tpu.stereo import DLNRConfig as JConfig
from gs2mesh_tpu.stereo import convert_torch_state_dict
from gs2mesh_tpu.stereo import corr as jcorr
from gs2mesh_tpu.stereo import dlnr as jdlnr
from gs2mesh_tpu.stereo import extractor as jext
from gs2mesh_tpu.stereo import layers as jl
from gs2mesh_tpu.stereo import padder as jpadder
from gs2mesh_tpu.stereo import refinement as jref
from gs2mesh_tpu.stereo import update as jupd
from gs2mesh_torch.core.precision import precision_scope
from gs2mesh_torch.stereo import (DLNR, DLNRConfig, InputPadder, dlnr_forward,
                                  init_dlnr_, load_checkpoint, load_weights,
                                  params_from_numpy)
from gs2mesh_torch.stereo import corr, layers, refinement, update
from gs2mesh_torch.stereo.dlnr import upsample_flow
from gs2mesh_torch.stereo.extractor import extractor_forward

torch.set_num_threads(1)

H, W = 64, 96
ITERS = 2
MODULE_TOL = 1e-5
FORWARD_TOL = 1e-4


def perturb_(model, seed=0):
    """Move every parameter and buffer off ParamMaker's values: running
    variances to U(0.5, 1.5), everything else by normal noise of 0.2 of its
    spread (0.1 where it has none: zero biases, unit norms and
    temperatures)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
                continue
            spread = float(t.std()) if t.numel() > 1 else 0.0
            scale = 0.2 * spread if spread > 0 else 0.1
            t.add_(torch.from_numpy(
                rng.normal(scale=scale, size=t.shape).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def model():
    m = DLNR()
    init_dlnr_(m, torch.Generator().manual_seed(0))
    return perturb_(m).eval()


@pytest.fixture(scope="module")
def jparams(model):
    return convert_torch_state_dict(model.state_dict())


def rand(*shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def port(fn, *args):
    with torch.inference_mode():
        return fn(*args)


def gap(got, want):
    """max |got - want| / max |want|; got a torch NCHW tensor (or array),
    want a JAX NHWC array (4-D) or any array of got's layout."""
    got = np.asarray(got)
    want = np.asarray(want)
    if want.ndim == 4 and want.shape != got.shape:
        want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_state_dict_round_trip_is_exact(model, jparams):
    sd = params_from_numpy(jparams)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


def test_load_checkpoint_strips_prefix_and_counters(model, tmp_path):
    path = str(tmp_path / "DLNR_Middlebury.pth")
    torch.save({"state_dict": {"module." + k: v
                               for k, v in model.state_dict().items()}}, path)
    state = load_checkpoint(path)
    assert not any(k.startswith("module.") or
                   k.endswith("num_batches_tracked") for k in state)
    fresh = load_weights(DLNR(), state)
    for (k, a), (_, b) in zip(fresh.state_dict().items(),
                              model.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
    with pytest.raises(KeyError):
        load_weights(DLNR(), {**state, "extra.weight": torch.zeros(1)})


def sub(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def mod(model, path):
    return model.get_submodule(path)


def t(a):
    return torch.from_numpy(a)


LAYER_CASES = {}


def layer_case(fn):
    """Register fn(model, jparams) -> (port output, JAX output)."""
    LAYER_CASES[fn.__name__] = fn
    return fn


@layer_case
def conv_depthwise(m, j):
    x, path = rand(2, 384, 8, 12, seed=1), \
        "extractor.encoder_level2.0.attn.qkv_dwconv"
    return (port(layers.conv2d, t(x), mod(m, path)),
            jl.conv2d(nhwc(x), sub(j, path), padding=1, groups=384))


@layer_case
def conv_transpose_2x(m, j):
    x, path = rand(2, 128, 4, 6, seed=2), \
        "normalizationRefinement.deconv4a.conv1.conv"
    return (port(layers.conv_transpose_2x, t(x), mod(m, path)),
            jl.conv_transpose_2x(nhwc(x), sub(j, path)))


@layer_case
def pixel_unshuffle(m, j):
    x = rand(2, 3, 16, 24, seed=3)
    return port(F.pixel_unshuffle, t(x), 4), jl.pixel_unshuffle(nhwc(x), 4)


@layer_case
def pixel_shuffle(m, j):
    x = rand(2, 64, 4, 6, seed=4)
    return port(F.pixel_shuffle, t(x), 2), jl.pixel_shuffle(nhwc(x), 2)


@layer_case
def layer_norm(m, j):
    x, path = rand(2, 128, 8, 12, seed=5), "extractor.encoder_level2.1.norm1"
    return (port(layers.layer_norm_bias, t(x), mod(m, path)),
            jl.layer_norm_bias(nhwc(x), sub(j, path + ".body")))


@layer_case
def batch_norm_eval(m, j):
    x, path = rand(2, 48, 8, 12, seed=6), "normalizationRefinement.conv1a.bn"
    return (port(layers.batch_norm_eval, t(x), mod(m, path)),
            jl.batch_norm_eval(nhwc(x), sub(j, path)))


@layer_case
def instance_norm(m, j):
    x = rand(2, 16, 8, 12, seed=7)
    return port(layers.instance_norm, t(x)), jl.instance_norm(nhwc(x))


@layer_case
def group_norm(m, j):
    x = rand(2, 32, 8, 12, seed=8)
    gn = torch.nn.GroupNorm(4, 32)
    w, b = rand(32, seed=9, lo=0.5, hi=1.5), rand(32, seed=10)
    with torch.no_grad():
        gn.weight.copy_(t(w))
        gn.bias.copy_(t(b))
    return (port(layers.group_norm, t(x), gn),
            jl.group_norm(nhwc(x), {"weight": w, "bias": b}, 4))


@layer_case
def channel_attention(m, j):
    x, path = rand(2, 128, 8, 12, seed=11), "extractor.encoder_level2.2.attn"
    return (port(layers.channel_attention, t(x), mod(m, path)),
            jl.channel_attention(nhwc(x), sub(j, path), 2))


@layer_case
def gdfn(m, j):
    x, path = rand(2, 64, 8, 12, seed=12), "extractor.encoder_level1.0.ffn"
    return (port(layers.gdfn, t(x), mod(m, path)),
            jl.gdfn(nhwc(x), sub(j, path)))


@layer_case
def transformer_block(m, j):
    x, path = rand(2, 256, 4, 6, seed=13), "extractor.decoder_level3.3"
    return (port(layers.transformer_block, t(x), mod(m, path)),
            jl.transformer_block(nhwc(x), sub(j, path), 4))


@layer_case
def downsample(m, j):
    x, path = rand(2, 128, 8, 12, seed=14), "extractor.down2_3"
    return (port(layers.downsample, t(x), mod(m, path)),
            jl.downsample(nhwc(x), sub(j, path)))


@layer_case
def upsample(m, j):
    x, path = rand(2, 256, 4, 6, seed=15), "extractor.up3_2"
    return (port(layers.upsample, t(x), mod(m, path)),
            jl.upsample(nhwc(x), sub(j, path)))


@layer_case
def residual_block_instance(m, j):
    x, path = rand(2, 128, 8, 12, seed=16), "volume_conv.0"
    return (port(layers.residual_block_instance, t(x), mod(m, path)),
            jl.residual_block_instance(nhwc(x), sub(j, path)))


@layer_case
def basic_conv_dilated_stride2(m, j):
    x, path = rand(2, 64, 16, 24, seed=17), "normalizationRefinement.conv3a"
    return (port(layers.basic_conv, t(x), mod(m, path)),
            jl.basic_conv(nhwc(x), sub(j, path), stride=2, padding=2,
                          dilation=2))


@layer_case
def conv2x_deconv(m, j):
    x, r = rand(2, 96, 4, 6, seed=18), rand(2, 64, 8, 12, seed=19)
    path = "normalizationRefinement.deconv3a"
    return (port(layers.conv2x, t(x), t(r), mod(m, path)),
            jl.conv2x(nhwc(x), nhwc(r), sub(j, path), deconv=True))


@layer_case
def conv2x(m, j):
    x, r = rand(2, 32, 16, 24, seed=20), rand(2, 48, 8, 12, seed=21)
    path = "normalizationRefinement.conv1b"
    return (port(layers.conv2x, t(x), t(r), mod(m, path)),
            jl.conv2x(nhwc(x), nhwc(r), sub(j, path)))


@layer_case
def avg_pool_2x(m, j):
    x = rand(2, 128, 16, 24, seed=22)
    return port(layers.avg_pool_2x, t(x)), jl.avg_pool_2x(nhwc(x))


@layer_case
def avg_pool_2x_odd(m, j):
    x = rand(2, 8, 9, 13, seed=23)
    return port(layers.avg_pool_2x, t(x)), jl.avg_pool_2x(nhwc(x))


@layer_case
def interp_bilinear(m, j):
    x = rand(2, 128, 4, 6, seed=24)
    return (port(layers.interp_bilinear, t(x), 8, 12),
            jl.interp_bilinear(nhwc(x), 8, 12))


@layer_case
def interp_bilinear_odd(m, j):
    x = rand(2, 8, 5, 7, seed=25)
    return (port(layers.interp_bilinear, t(x), 9, 13),
            jl.interp_bilinear(nhwc(x), 9, 13))


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(name, model, jparams):
    got, want = LAYER_CASES[name](model, jparams)
    assert gap(got, want) <= MODULE_TOL


def test_extractor_matches_jax(model, jparams):
    x = rand(2, 3, H, W, seed=30)
    got = port(extractor_forward, t(x), model.extractor)
    want = jext.extractor_forward(nhwc(x), jparams["extractor"])
    for level in range(3):
        for head in range(2):
            assert gap(got[level][head], want[level][head]) <= MODULE_TOL, \
                (level, head)
    assert gap(got[3], want[3]) <= MODULE_TOL


def test_corr_pyramid_and_lookup_match_jax():
    f1, f2 = rand(2, 256, 16, 24, seed=31), rand(2, 256, 16, 24, seed=32)
    # x from 10 left of the volume to 10 right of it: taps out of range on
    # both sides at every level, and integer positions.
    x = rand(2, 16, 24, seed=33, lo=-10.0, hi=34.0)
    x[0, 0, :8] = np.arange(8)
    got_pyr = port(corr.build_corr_pyramid, t(f1), t(f2), 4)
    with jl.matmul_dtype(None):
        want_pyr = jcorr.build_corr_pyramid(nhwc(f1), nhwc(f2), 4)
    for g, w_ in zip(got_pyr, want_pyr):
        assert gap(g, w_) <= MODULE_TOL
    got = port(corr.lookup_corr, got_pyr, t(x), 4)
    want = jcorr.lookup_corr(want_pyr, jnp.asarray(x), 4)
    assert gap(got, want) <= MODULE_TOL
    # Same pyramid on both sides: the gather picks the compare-mask's value.
    same = port(corr.lookup_corr, [t(np.array(p)) for p in want_pyr], t(x),
                4)
    assert gap(same, want) <= 1e-6


def test_update_block_matches_jax(model, jparams):
    shapes = [(16, 24), (8, 12), (4, 6)]
    net = [rand(2, 128, h, w, seed=40 + i) for i, (h, w) in enumerate(shapes)]
    ext = [tuple(rand(2, 128, h, w, seed=50 + 4 * i + g) for g in range(4))
           for i, (h, w) in enumerate(shapes)]
    cor, flow = rand(2, 36, 16, 24, seed=60), rand(2, 2, 16, 24, seed=61,
                                                   lo=-3, hi=3)
    tt = [t(a) for a in net]
    got = port(update.update_block, tt, tt,
               [tuple(t(a) for a in e) for e in ext], t(cor), t(flow),
               model.update_block)
    jn = [nhwc(a) for a in net]
    want = jupd.update_block(jn, jn, [tuple(nhwc(a) for a in e) for e in ext],
                             nhwc(cor), nhwc(flow), jparams["update_block"])
    for i in range(3):
        assert gap(got[0][i], want[0][i]) <= MODULE_TOL
        assert gap(got[1][i], want[1][i]) <= MODULE_TOL
    assert gap(got[2], want[2]) <= MODULE_TOL
    assert gap(got[3], want[3]) <= MODULE_TOL


def test_refinement_and_disp_warp_match_jax(model, jparams):
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    disp = -(4.0 + 3.0 * np.sin(xx / 9.0) + 2.0 * np.cos(yy / 7.0))
    low = np.stack([disp, disp[:, ::-1] - 0.5])[:, None].astype(np.float32)
    left, right = rand(2, 3, H, W, seed=70), rand(2, 3, H, W, seed=71)
    got = port(refinement.disp_warp, t(right), t(-low))
    want = jref.disp_warp(nhwc(right), nhwc(-low))
    assert gap(got, want) <= MODULE_TOL
    got = port(refinement.refinement_forward, t(low), t(left), t(right),
               model.normalizationRefinement)
    want = jref.refinement_forward(nhwc(low), nhwc(left), nhwc(right),
                                   jparams["normalizationRefinement"])
    assert gap(got, want) <= MODULE_TOL


def test_upsample_flow_matches_jax():
    flow = rand(2, 2, 16, 24, seed=80, lo=-5, hi=5)
    mask = rand(2, 144, 16, 24, seed=81, lo=-4, hi=4)
    got = port(upsample_flow, t(flow), t(mask), 4)
    want = jdlnr.upsample_flow(nhwc(flow), nhwc(mask), 4)
    assert gap(got, want) <= MODULE_TOL


def test_input_padder_matches_jax():
    x = rand(1, 3, 50, 70, seed=90)
    want = jpadder.InputPadder(x.shape, divis_by=32).pad(x)[0]
    p = InputPadder(x.shape, divis_by=32)
    (got_np,), (got_t,) = p.pad(x), p.pad(t(x))
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(p.unpad(got_t).numpy(), x)


def images(seed):
    """An [LR, RL]-style batch: a random left image, the right one shifted
    by 3 pixels, and the flipped pair as the second row."""
    left = rand(1, 3, H, W, seed=seed, lo=0.0, hi=255.0)
    right = np.roll(left, 3, axis=3)
    return (np.concatenate([left, right[..., ::-1]]),
            np.concatenate([right, left[..., ::-1]]))


FORWARD_CASES = ("cold", "warm", "refined")


@pytest.fixture(scope="module")
def forwards(model, jparams):
    """Each case's disparity and low-res flow from the port in float32, the
    port in float64 and JAX, and whether the port refined: cold, warm from
    the cold flow, and warm from a flow so negative that the refinement
    runs."""
    a, b = images(100)
    jcfg = JConfig(iters=ITERS)
    cold = jax.jit(lambda p, x, y: jdlnr.dlnr_forward(p, x, y, jcfg))
    warm = jax.jit(lambda p, x, y, f: jdlnr.dlnr_forward(p, x, y, jcfg,
                                                         flow_init=f))
    with jl.matmul_dtype(None):
        jc = cold(jparams, a, b)
        jw = warm(jparams, a, b, jc[0])
        neg = np.full(np.shape(jc[0]), -40.0, np.float32)
        jr = warm(jparams, a, b, neg)
    cfg = DLNRConfig(iters=ITERS)
    m64 = copy.deepcopy(model).double()
    out = {}
    for name, init, j in (("cold", None, jc), ("warm", np.asarray(jc[0]), jw),
                          ("refined", neg, jr)):
        init = None if init is None else t(np.array(init))
        with torch.inference_mode():
            f32, d32 = dlnr_forward(model, t(a), t(b), cfg, init)
            refined = model.last_refined
            f64, d64 = dlnr_forward(m64, t(a).double(), t(b).double(), cfg,
                                    None if init is None else init.double())
        out[name] = dict(port=(f32, d32), f64=(f64, d64),
                         jax=(np.asarray(j[0]), np.asarray(j[1])),
                         refined=refined)
    return out


@pytest.mark.parametrize("case", FORWARD_CASES)
def forward_limit(jax32, exact):
    """Whole-forward tolerance, relative to the largest |value| of the
    float64 forward ``exact``: 1e-4, or 4x JAX's own float32 error where
    that is larger. This random-weight net amplifies float32 rounding: a
    1e-7 relative change of one input image moves its disparity by ~5e-4
    of the maximum after two iterations. Over twelve seeded inputs at 1 and
    2 iterations JAX's float32 forward was 5e-5 to 5e-4 from the float64
    one, and the port's gaps to JAX and to float64 at most 3.3x and 2.6x
    JAX's (ROADMAP queue C). JAX must stay within 2e-3 of the float64
    forward: the port in float64 and JAX compute the same function."""
    jax_err = float(np.abs(jax32 - exact).max() / np.abs(exact).max())
    assert jax_err <= 2e-3
    return max(FORWARD_TOL, 4 * jax_err)


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_dlnr_forward_matches_jax(case, forwards):
    """The port's float32 forward against JAX's and against its own float64
    forward, within forward_limit."""
    r = forwards[case]
    (flow_low, disp), (f64, d64), (jflow, jdisp) = r["port"], r["f64"], \
        r["jax"]
    assert r["refined"] is (case == "refined")
    assert flow_low.shape == jflow.shape == (2, 2, H // 4, W // 4)
    assert disp.shape == jdisp.shape == (2, 1, H, W)
    assert float(flow_low[:, 1].abs().max()) == 0.0     # y pinned to zero
    for port32, jax32, exact in ((disp, jdisp, d64), (flow_low, jflow, f64)):
        exact = exact.numpy()
        limit = forward_limit(jax32, exact)
        scale = np.abs(exact).max()
        assert np.abs(port32.numpy() - jax32).max() / scale <= limit
        assert np.abs(port32.numpy() - exact).max() / scale <= limit


def test_refinement_gate_is_batch_wide(model):
    """One row negative enough to refine and one not: no row is refined
    (core/dlnr.py:120-126 tests the max over the whole batch)."""
    a, b = images(101)
    init = np.full((2, 2, H // 4, W // 4), -40.0, np.float32)
    init[1] = 40.0
    with torch.inference_mode():
        dlnr_forward(model, t(a), t(b), DLNRConfig(iters=1), t(init))
        assert model.last_refined is False
        init[1] = -40.0
        dlnr_forward(model, t(a), t(b), DLNRConfig(iters=1), t(init))
        assert model.last_refined is True


def test_bf16_policy_close_to_f32():
    """The bf16 operand policy against float32, as
    tests/test_stereo_dlnr.py:77-105 holds the JAX policy (seeded init,
    images from seed 4, 2 iterations): max |d| within 0.15 of the largest
    |disparity|."""
    model = init_dlnr_(DLNR(), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 255, (1, 3, H, W)).astype(np.float32)
    b = rng.uniform(0, 255, (1, 3, H, W)).astype(np.float32)
    cfg = DLNRConfig(iters=ITERS)
    with torch.inference_mode():
        _, d32 = dlnr_forward(model, t(a), t(b), cfg)
        with layers.matmul_dtype(torch.bfloat16):
            _, d16 = dlnr_forward(model, t(a), t(b), cfg)
    assert d16.dtype == torch.float32 and bool(torch.isfinite(d16).all())
    scale = max(float(d32.abs().max()), 1e-3)
    assert float((d32 - d16).abs().max()) / scale < 0.15
    assert not torch.equal(d32, d16)


def test_precision_scopes_restore_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with precision_scope():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    with layers.matmul_dtype(torch.bfloat16):
        assert layers._MATMUL_DTYPE.get() is torch.bfloat16
    assert layers._MATMUL_DTYPE.get() is None

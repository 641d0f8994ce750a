"""The preprocess kernels' plain versions and routing, on the CPU.

Kernels P1 and P2 (``gs2mesh_torch/csrc/preprocess.cu``) run only on the
card (``chip_smoke.py`` holds them to these plain versions there). Here:

  (a) ``preprocess_backward_plain`` (P2's plain version) against autograd
      of ``preprocess_plain`` (P1's), in float64 within 1e-9 relative and
      through ``torch.autograd.gradcheck``, and in float32 within rtol 1e-5
      / atol 1e-6 beyond autograd's own float32 error (its distance to the
      float64 gradient, where a few covariance chains cancel);
  (b) the same cotangents against ``jax.vjp`` of the JAX package's
      preprocess, at PARITY.md's gradient tolerance (atol 5e-5, rtol 5e-3);
  (c) the routing: CPU tensors never reach a kernel, the precomp routes
      stay plain, CUDA tensors go to ``PreprocessFunction``, an unknown
      device raises;
  (d) ``PreprocessFunction`` with its kernels swapped for their plain
      versions gives ``rasterize`` the gradients of the plain route.

Scenes are tests/scenes.py's seeded spheres at SH 0 and 3 with rows
behind the near plane, beyond the FoV clamp, under the 1/255 opacity cut
and dead (opacity 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.ops.rasterizer.preprocess import preprocess as j_preprocess
from gs2mesh_torch.ops.rasterizer import api, preprocess_kernel_wrappers
from gs2mesh_torch.ops.rasterizer import preprocess as pp
from gs2mesh_torch.ops.rasterizer import rasterize
from tests import test_rasterizer as tr
from tests.scenes import sphere_scene
from tests.test_torch_rasterizer import BG, CAM, CFG

torch.set_num_threads(1)

KEYS = ("means3d", "scales", "rotations", "opacities", "shs")
GRAD_KEYS = ("means3d", "scales", "rotations", "shs")
CAMERA_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx",
                 "tan_fovy")


def edge_scene(n, sh_degree, seed=0):
    """A sphere scene whose first rows sit behind the near plane, beyond the
    FoV clamp, under the 1/255 opacity cut and dead."""
    s = sphere_scene(n=n, seed=seed, sh_degree=sh_degree)
    m = n // 12
    s["means3d"][:m, 2] = -10.0                         # behind the camera
    s["means3d"][m:2 * m, :2] *= 4.0                    # past the FoV clamp
    s["opacities"][2 * m:3 * m] = 0.002                 # under 1/255
    s["opacities"][3 * m:4 * m] = 0.0                   # dead
    return {k: s[k] for k in KEYS}


def cotangents(n, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, c)).astype(np.float32)
                 for c in (2, 3, 3))


def camera_as(dtype):
    return dataclasses.replace(CAM, **{f: getattr(CAM, f).to(dtype)
                                       for f in CAMERA_FIELDS})


def autograd_grads(s, cot, sh_degree, dtype):
    leaves = [torch.from_numpy(s[k]).to(dtype).requires_grad_(True)
              for k in KEYS]
    out = pp.preprocess_plain(*leaves, camera_as(dtype), sh_degree, CFG,
                              float_type=dtype)
    return torch.autograd.grad(
        (out.means2d, out.conic, out.rgb),
        [leaves[KEYS.index(k)] for k in GRAD_KEYS],
        [torch.from_numpy(c).to(dtype) for c in cot])


def plain_grads(s, cot, sh_degree, dtype):
    return pp.preprocess_backward_plain(
        *(torch.from_numpy(s[k]).to(dtype) for k in GRAD_KEYS),
        camera_as(dtype), sh_degree, CFG, 1.0,
        *(torch.from_numpy(c).to(dtype) for c in cot), float_type=dtype)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_backward_plain_matches_autograd(sh_degree):
    s = edge_scene(300, sh_degree)
    cot = cotangents(300)
    a64 = autograd_grads(s, cot, sh_degree, torch.float64)
    p64 = plain_grads(s, cot, sh_degree, torch.float64)
    a32 = autograd_grads(s, cot, sh_degree, torch.float32)
    p32 = plain_grads(s, cot, sh_degree, torch.float32)
    for name, ra64, rp64, ra32, rp32 in zip(GRAD_KEYS, a64, p64, a32, p32):
        torch.testing.assert_close(rp64, ra64, rtol=1e-9, atol=1e-12,
                                   msg=name)
        assert rp32.dtype == torch.float32 and rp32.shape == ra32.shape
        own = (ra32.double() - ra64).abs()     # autograd's float32 error
        gap = (rp32.double() - ra32.double()).abs()
        allowed = 1e-6 + 1e-5 * ra32.double().abs() + 2.0 * own
        assert bool((gap <= allowed).all()), (name, float(gap.max()))
        assert bool(torch.isfinite(rp32).all()), name
    # Past the used SH coefficients the gradient is exactly zero.
    if sh_degree == 0:
        assert bool((p32[3][:, 1:] == 0).all())


def test_backward_plain_zero_where_autograd_is():
    """Culled rows still carry conic and mean gradients (autograd's too);
    a colour clamped at 0 and unused coefficients carry none."""
    s = edge_scene(120, 3)
    s["shs"][:10, 0, :] = -5.0                          # rgb clamped at 0
    s["shs"] = np.concatenate([s["shs"], np.ones((120, 2, 3), np.float32)],
                              axis=1)                   # K = 18 > 16
    cot = cotangents(120, seed=2)
    a = autograd_grads(s, cot, 3, torch.float64)
    p = plain_grads(s, cot, 3, torch.float64)
    for name, x, y in zip(GRAD_KEYS, p, a):
        assert torch.equal(x == 0, y == 0), name
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12, msg=name)
    assert bool((p[3][:10] == 0).all()) and bool((p[3][:, 16:] == 0).all())


class _PlainBackward(torch.autograd.Function):
    """preprocess_plain's means2d, conic and rgb, differentiated by
    preprocess_backward_plain (for gradcheck)."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, shs, opacities, camera,
                sh_degree):
        out = pp.preprocess_plain(means3d, scales, rotations, opacities, shs,
                                  camera, sh_degree, CFG,
                                  float_type=torch.float64)
        ctx.save_for_backward(means3d, scales, rotations, shs)
        ctx.args = (camera, sh_degree)
        return out.means2d, out.conic, out.rgb

    @staticmethod
    def backward(ctx, dmeans2d, dconic, drgb):
        camera, sh_degree = ctx.args
        g = pp.preprocess_backward_plain(*ctx.saved_tensors, camera,
                                         sh_degree, CFG, 1.0, dmeans2d,
                                         dconic, drgb,
                                         float_type=torch.float64)
        return (*g, None, None, None)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_backward_plain_gradcheck(sh_degree):
    s = edge_scene(12, sh_degree, seed=3)
    x = [torch.from_numpy(s[k]).double().requires_grad_(True)
         for k in GRAD_KEYS]
    op = torch.from_numpy(s["opacities"]).double()
    cam = camera_as(torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: _PlainBackward.apply(*a, op, cam, sh_degree), x,
        eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_backward_plain_matches_jax_vjp(sh_degree):
    s = edge_scene(240, sh_degree, seed=4)
    cot = cotangents(240, seed=5)

    def f(m, sc, r, sh):
        p = j_preprocess(m, sc, r, jnp.asarray(s["opacities"]), sh, tr.CAM,
                         sh_degree, tr.CFG)
        return p.means2d, p.conic, p.rgb

    _, vjp = jax.vjp(f, *(jnp.asarray(s[k]) for k in GRAD_KEYS))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    got = plain_grads(s, cot, sh_degree, torch.float32)
    for name, a, b in zip(GRAD_KEYS, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=5e-3, err_msg=name)


def test_float64_means_compute_in_float32():
    """The plain route casts the means to float32, as the JAX package does:
    float64 means give the float32 call's outputs, bit for bit."""
    s = edge_scene(96, 3)
    x = [torch.from_numpy(s[k]) for k in KEYS]
    ref = pp.preprocess(*x, CAM, 3, CFG)
    got = pp.preprocess(x[0].double(), *x[1:], CAM, 3, CFG)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert ref.means2d.dtype == ref.conic.dtype == torch.float32


def test_cpu_tensors_never_reach_the_kernels():
    wrappers = preprocess_kernel_wrappers()
    assert set(wrappers) == {"P1", "P2"}
    before = {k: w.launches for k, w in wrappers.items()}
    s = edge_scene(96, 3)
    x = [torch.from_numpy(s[k]).requires_grad_(True) for k in KEYS]
    out = rasterize(*x, CAM, 3, bg=BG, cfg=CFG)
    (out.image ** 2).mean().backward()
    pp.preprocess(*(t.detach() for t in x), CAM, 3, CFG)
    assert {k: w.launches for k, w in wrappers.items()} == before
    with pytest.raises(ValueError, match="expected cuda"):
        pp.preprocess_forward_cuda(*(t.detach() for t in x), CAM, 3, CFG,
                                   1.0)
    with pytest.raises(ValueError, match="expected cuda"):
        pp.preprocess_backward_cuda(
            *(x[KEYS.index(k)].detach() for k in GRAD_KEYS), CAM, 3, CFG,
            1.0, *(torch.from_numpy(c) for c in cotangents(96)))
    assert {k: w.launches for k, w in wrappers.items()} == before


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to follow the
    dispatch of ``preprocess`` without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_routing(monkeypatch):
    calls = []
    monkeypatch.setattr(pp, "preprocess_plain",
                        lambda *a, **k: calls.append("plain") or "plain")
    monkeypatch.setattr(pp, "preprocess_fused",
                        lambda *a, **k: calls.append("fused") or "fused")
    s = edge_scene(24, 0)
    cpu = [torch.from_numpy(s[k]) for k in KEYS]
    cuda = [t.as_subclass(_OnCuda) for t in cpu]
    cov = torch.eye(3).expand(24, 3, 3)
    col = torch.zeros(24, 3)
    assert pp.preprocess(*cpu, CAM, 0, CFG) == "plain"
    assert pp.preprocess(*cuda, CAM, 0, CFG) == "fused"
    assert pp.preprocess(*cuda, CAM, 0, CFG, cov3d_precomp=cov) == "plain"
    assert pp.preprocess(*cuda, CAM, 0, CFG, colors_precomp=col) == "plain"
    assert calls == ["plain", "fused", "plain", "plain"]
    meta = [torch.empty(t.shape, device="meta") for t in cpu]
    with pytest.raises(ValueError, match="unsupported device meta"):
        pp.preprocess(*meta, CAM, 0, CFG)


def _plain_p1(*a):
    o = pp.preprocess_plain(*a[:9])
    return (o.means2d, o.depths, o.conic, o.rgb, o.radius, o.rect,
            o.tiles_touched)


def _fused_on_cpu(*a, cov3d_precomp=None, colors_precomp=None):
    """``preprocess`` as it routes CUDA tensors, for CPU ones."""
    assert cov3d_precomp is None and colors_precomp is None
    return pp.preprocess_fused(*a)


def _rasterize_grads(s, sh_degree):
    x = [torch.from_numpy(np.array(s[k])).requires_grad_(True) for k in KEYS]
    offs = torch.zeros((x[0].shape[0], 2), requires_grad=True)
    out = rasterize(*x, CAM, sh_degree, bg=BG, cfg=CFG,
                    screenspace_offset=offs)
    loss = torch.mean(out.image ** 2) + 0.1 * torch.mean(out.final_T)
    return out, torch.autograd.grad(loss, x + [offs])


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_function_gives_rasterize_the_plain_gradients(monkeypatch,
                                                      sh_degree):
    s = edge_scene(240, sh_degree, seed=6)
    ref_out, ref = _rasterize_grads(s, sh_degree)
    monkeypatch.setattr(pp, "preprocess_forward_cuda", _plain_p1)
    monkeypatch.setattr(pp, "preprocess_backward_cuda",
                        pp.preprocess_backward_plain)
    monkeypatch.setattr(api, "preprocess", _fused_on_cpu)
    out, got = _rasterize_grads(s, sh_degree)
    assert torch.equal(out.image, ref_out.image)
    assert torch.equal(out.radii, ref_out.radii)
    assert int(out.num_pairs) == int(ref_out.num_pairs) > 0
    for name, a, b in zip(KEYS + ("screenspace_offset",), got, ref):
        scale = float(b.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale,
                                   msg=name)
    # The opacity's gradient bypasses the function: the same ops.
    assert torch.equal(got[3], ref[3])

"""The GS tools' neighbours in the port (gs2mesh_torch.metrics.lpips,
ops/rasterizer/golden.py, the preprocess's cov3d_precomp / colors_precomp
inputs) and cli/gs_tools.py's main and errors, against the JAX package's,
on the CPU (the tools themselves: tests/test_torch_gs_tools_eval.py).

Limits: LPIPS within 2e-4 relative (tests/test_lpips.py's), its seeded
initialiser and checkpoint conversion bit-equal; the golden renderer and
the precomp renders within 2e-5 (PARITY.md:45), the golden gradients
within atol 5e-5 / rtol 5e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.metrics import convert_lpips_checkpoint as j_convert_lpips
from gs2mesh_tpu.metrics import init_lpips_params as j_init_lpips
from gs2mesh_tpu.metrics import lpips as j_lpips
from gs2mesh_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from gs2mesh_tpu.ops.rasterizer.golden import \
    composite_pixels as j_composite_pixels
from gs2mesh_tpu.ops.rasterizer.golden import render_golden as j_golden
from gs2mesh_tpu.ops.rasterizer.preprocess import build_cov3d as j_build_cov3d
from gs2mesh_tpu.ops.rasterizer.preprocess import preprocess as j_preprocess
from gs2mesh_torch.cli import gs_tools
from gs2mesh_torch.metrics import (LPIPS, convert_lpips_checkpoint,
                                   init_lpips_params, load_lpips, lpips)
from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
from gs2mesh_torch.ops.rasterizer.golden import render_golden
from gs2mesh_torch.ops.rasterizer.preprocess import build_cov3d, preprocess
from tests.scenes import look_at_camera as j_look_at_camera
from tests.scenes import sphere_scene
from tests.test_torch_core import look_at_camera

torch.set_num_threads(1)

KEYS = ("means3d", "scales", "rotations", "opacities", "shs")
EXACT = dict(feat_carry_bf16=False, grad_carry_bf16=False)
CFG = RasterizerConfig(pair_capacity=1 << 14)
JCFG = JRasterizerConfig(pair_capacity=1 << 14, **EXACT)
BG = np.array([0.1, 0.2, 0.3], np.float32)
EYES = [(0.0, 0.0, -3.0), (0.3, 0.1, -2.9), (-0.3, 0.2, -2.9),
        (0.2, -0.2, -3.1)]


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ------------------------------------------------------------------ LPIPS

def test_lpips_matches_jax():
    rng = np.random.default_rng(3)
    state = init_lpips_params(seed=1)
    jp = j_init_lpips(seed=1)
    # The seeded initialiser is JAX's, bit for bit.
    convs = [k for k in state if k.endswith(".weight")]
    for k, p in zip(convs, jp["convs"]):
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(p["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(state[k[:-6] + "bias"].numpy(),
                                      np.asarray(p["b"]))
    for i, lin in enumerate(jp["lins"]):
        np.testing.assert_array_equal(state[f"lins.{i}"].numpy(),
                                      np.asarray(lin))
    net = load_lpips(state, "cpu")
    a = rng.uniform(0, 1, (2, 3, 64, 96)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape).astype(np.float32), 0, 1)
    got = lpips(net, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_lpips(jp, a, b))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert float(lpips(net, torch.from_numpy(a), torch.from_numpy(a))[0]) \
        == pytest.approx(0.0, abs=1e-7)


def write_lpips_weights(root, seed=1):
    """Seeded weights as the two files the reference reads: a torchvision
    VGG16 state dict (features.N.{weight,bias}, the classifier too) and
    LPIPS v0.1's heads (lin{i}.model.1.weight, (1, C, 1, 1))."""
    state = init_lpips_params(seed)
    vgg = {k: v for k, v in state.items() if k.startswith("features.")}
    vgg["classifier.0.weight"] = torch.zeros(4, 3)
    lin = {f"lin{i}.model.1.weight": state[f"lins.{i}"].reshape(1, -1, 1, 1)
           for i in range(5)}
    paths = (os.path.join(root, "vgg16.pth"), os.path.join(root, "lin.pth"))
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return paths, state


def test_convert_lpips_checkpoint_matches_jax(tmp_path):
    (vgg, lin), state = write_lpips_weights(str(tmp_path))
    got = convert_lpips_checkpoint(vgg, lin)
    assert set(got) == set(LPIPS().state_dict())
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    jp = j_convert_lpips(vgg, lin)
    for i, lin_w in enumerate(jp["lins"]):
        np.testing.assert_array_equal(got[f"lins.{i}"].numpy(),
                                      np.asarray(lin_w))


# ------------------------------------------------------- golden + precomp

def scene(n=400, sh_degree=1):
    s = sphere_scene(n=n, seed=5, sh_degree=sh_degree)
    return ({k: torch.from_numpy(s[k]) for k in KEYS},
            {k: jnp.asarray(s[k]) for k in KEYS})


def test_render_golden_matches_jax():
    p, j = scene()
    cam = look_at_camera(EYES[1], 64, 48)
    jcam = j_look_at_camera(EYES[1], width=64, height=48)
    leaves = {k: v.clone().requires_grad_(k != "shs") for k, v in p.items()}
    img, T, _ = render_golden(*(leaves[k] for k in KEYS), cam, 1,
                              bg=torch.from_numpy(BG), cfg=CFG)
    jimg, jT, _ = j_golden(*(j[k] for k in KEYS), jcam, 1,
                           bg=jnp.asarray(BG), cfg=JCFG)
    assert float(np.abs(img.detach().numpy() - np.asarray(jimg)).max()) < 2e-5
    assert float(np.abs(T.detach().numpy() - np.asarray(jT)).max()) < 2e-5
    # Differentiable by autograd, as JAX's by jax.grad.
    torch.mean(img ** 2).backward()
    jg = jax.grad(lambda m, s, r, o: jnp.mean(j_golden(
        m, s, r, o, j["shs"], jcam, 1, bg=jnp.asarray(BG), cfg=JCFG)[0] ** 2),
        argnums=(0, 1, 2, 3))(*(j[k] for k in KEYS[:4]))
    for k, g in zip(KEYS[:4], jg):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   atol=5e-5, rtol=5e-3)
    # The plain compositor (K2's plain version) against the golden renderer.
    with torch.no_grad():
        out = rasterize(*(p[k] for k in KEYS), cam, 1,
                        bg=torch.from_numpy(BG), cfg=CFG)
    assert float((out.image - img.detach()).abs().max()) < 2e-5


def test_precomp_inputs_match_jax():
    """rasterize with cov3d_precomp / colors_precomp against JAX's
    preprocess with the same inputs composited by its golden compositor
    (JAX's rasterize does not take them)."""
    p, j = scene(sh_degree=0)
    rng = np.random.default_rng(7)
    colors = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    cov = build_cov3d(p["scales"] * 1.3, p["rotations"])
    jcov = j_build_cov3d(j["scales"] * 1.3, j["rotations"])
    assert rel(cov, jcov) < 1e-6
    cam = look_at_camera(EYES[2], 64, 64)
    jcam = j_look_at_camera(EYES[2], width=64, height=64)
    prep = preprocess(*(p[k] for k in KEYS), cam, 0, CFG,
                      cov3d_precomp=torch.from_numpy(np.array(jcov)),
                      colors_precomp=torch.from_numpy(colors))
    jprep = j_preprocess(*(j[k] for k in KEYS), jcam, 0, JCFG,
                         cov3d_precomp=jcov,
                         colors_precomp=jnp.asarray(colors))
    np.testing.assert_array_equal(prep.rgb.numpy(), colors)
    for f in ("radius", "rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(prep, f).numpy(),
                                      np.asarray(getattr(jprep, f)))
    assert rel(prep.conic, jprep.conic) < 1e-5
    out = rasterize(*(p[k] for k in KEYS), cam, 0, bg=torch.from_numpy(BG),
                    cfg=CFG, cov3d_precomp=torch.from_numpy(np.array(jcov)),
                    colors_precomp=torch.from_numpy(colors))
    order = jnp.argsort(jprep.depths, stable=True)
    jimg, jT = j_composite_pixels(jprep, order, 64, 64, jnp.asarray(BG), JCFG)
    assert float(np.abs(out.image.numpy() - np.asarray(jimg)).max()) < 2e-5
    assert float(np.abs(out.final_T.numpy() - np.asarray(jT)).max()) < 2e-5
    # Without the precomputed inputs it is the ordinary render.
    base = rasterize(*(p[k] for k in KEYS), cam, 0, bg=torch.from_numpy(BG),
                     cfg=CFG)
    assert float((base.image - out.image).abs().max()) > 1e-2


def test_main_dispatches(tmp_path, monkeypatch):
    calls = []
    for name in ("gs_train", "gs_render", "gs_metrics"):
        monkeypatch.setattr(gs_tools, name,
                            lambda *a, _n=name, **kw: calls.append((_n, a,
                                                                    kw)))
    gs_tools.main(["train", "-s", "S", "-m", "M", "--iterations", "5",
                   "--eval"])
    gs_tools.main(["render", "-m", "M", "--iteration", "3", "--skip_train"])
    gs_tools.main(["metrics", "-m", "A", "B", "--lpips"])
    assert calls[0][0] == "gs_train" and calls[0][1][:3] == ("S", "M", 5)
    assert calls[0][2] == {"eval_split": True, "gui": False}
    assert calls[1] == ("gs_render", ("M", None, 3, True, False), {})
    assert calls[2] == ("gs_metrics", (["A", "B"],), {"lpips": True})


def test_gs_tools_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        gs_tools.gs_metrics([str(tmp_path)])

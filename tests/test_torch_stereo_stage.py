"""The port's stereo stage (gs2mesh_torch.pipeline.stereo_stage) and DLNR
evaluation harness (gs2mesh_torch.cli.dlnr_eval) against the JAX package's,
and the host writers they use against PIL, matplotlib and cv2, on the CPU.

Both stages read the same pre-written PNG pairs (60x90, padded to 64x96)
through a renderer stub, with the same weights and 2 iterations:
  * with the JAX stage's forward replaced by the port's, the two stages'
    host logic (padding, the [LR, RL] flip and swap, warm start, sign,
    unpad, occlusion mask, depth, every artifact and its PNG) must give
    equal files, warm start included;
  * with each package's own forward, cold views: the tolerances of
    test_stage_matches_jax.
"""

import copy
import os
import shutil

import cv2
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from gs2mesh_tpu.cli import dlnr_eval as jeval
from gs2mesh_tpu.pipeline.config import DEFAULT_VALUES as JDEFAULTS
from gs2mesh_tpu.pipeline.config import PipelineArgs as JArgs
from gs2mesh_tpu.pipeline.stereo_stage import DISPARITY_SIGNS as JSIGNS
from gs2mesh_tpu.pipeline.stereo_stage import Stereo as JStereo
from gs2mesh_tpu.stereo import DLNRConfig as JConfig
from gs2mesh_tpu.stereo import convert_torch_state_dict
from gs2mesh_torch.cli.dlnr_eval import epe_d1, evaluate_folder, read_pfm
from gs2mesh_torch.core.colormap import jet, jet_lut
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.core.transforms import get_shading
from gs2mesh_torch.pipeline import PipelineArgs, Stereo
from gs2mesh_torch.pipeline.config import DEFAULT_VALUES
from gs2mesh_torch.pipeline.stereo_stage import (DISPARITY_SIGNS,
                                                 load_torch_checkpoint)
from gs2mesh_torch.stereo import DLNR, DLNRConfig, dlnr_forward, init_dlnr_
from tests.test_torch_stereo import forward_limit, perturb_

torch.set_num_threads(1)

H, W, N_VIEWS = 60, 90, 3
ITERS = 2
OUT = "out_DLNR_Middlebury"
ARTIFACTS = sorted(f"{name}.{ext}" for name in ("disparity_LR",
                                                 "disparity_RL",
                                                 "occlusion_mask", "depth")
                   for ext in ("npy", "png")) + ["shading.png"]


class StubRenderer:
    """The renderer's interface to the stage, over pre-written pairs."""

    def __init__(self, root):
        self.root = root
        self.baseline = 0.07
        self.left_cameras = [{"fx": 80.0 + i} for i in range(N_VIEWS)]
        self.rendered = []

    def render_folder_name(self, i):
        return os.path.join(self.root, f"{i:03}")

    def render_image_pair(self, i):
        self.rendered.append(i)


def texture(rng):
    """A smooth random RGB texture, 8 columns wider than a view."""
    yy, xx = np.mgrid[0:H, 0:W + 8].astype(np.float64)
    img = np.zeros((H, W + 8, 3))
    for _ in range(12):
        f, ph = rng.uniform(0.05, 0.6, 2), rng.uniform(0, 6.3, 3)
        img += np.sin(f[0] * xx[..., None] + f[1] * yy[..., None] + ph)
    return (img - img.min()) / (img.max() - img.min()) * 255


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """One directory of PNG pairs (right = left shifted 2 px) to copy."""
    root = str(tmp_path_factory.mktemp("pairs"))
    rng = np.random.default_rng(0)
    for i in range(N_VIEWS):
        img = texture(rng)
        os.makedirs(os.path.join(root, f"{i:03}"))
        for name, cols in (("left", slice(4, W + 4)),
                           ("right", slice(2, W + 2))):
            write_png(os.path.join(root, f"{i:03}", f"{name}.png"),
                      img[:, cols].round().astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def model():
    m = DLNR()
    init_dlnr_(m, torch.Generator().manual_seed(0))
    return perturb_(m).eval()


def stages(tmp_path, pairs, model, warm, jax_forward):
    """Run the JAX stage (with its own forward, or the port's) and the
    port's stage over copies of ``pairs``. Returns the two roots and each
    stage's forward calls as numpy (image1, image2, flow_init, flow_low,
    disp)."""
    args = {}
    for side in ("jax", "port"):
        shutil.copytree(pairs, tmp_path / side)
        args[side] = (JArgs if side == "jax" else PipelineArgs).for_dataset(
            "DTU", stereo_warm=warm)
    js = JStereo(str(tmp_path), StubRenderer(str(tmp_path / "jax")),
                 args["jax"],
                 params=convert_torch_state_dict(model.state_dict()))
    js.cfg = JConfig(iters=ITERS)
    cfg = DLNRConfig(iters=ITERS)
    calls = {"jax": [], "port": []}

    def port_forward(b1, b2, flow_init):
        with torch.inference_mode():
            f, d = dlnr_forward(
                model, torch.from_numpy(b1), torch.from_numpy(b2), cfg,
                None if flow_init is None else torch.from_numpy(flow_init))
        return f.numpy(), d.numpy()

    def recorded(fn, side, to_numpy):
        def call(b1, b2, flow_init):
            out = fn(b1, b2, flow_init)
            calls[side].append(tuple(
                None if a is None else np.array(to_numpy(a))
                for a in (b1, b2, flow_init, *out)))
            return out
        return call

    js._forward = recorded(js._forward if jax_forward else port_forward,
                           "jax", np.asarray)
    js.run()
    stub = StubRenderer(str(tmp_path / "port"))
    ps = Stereo(str(tmp_path), stub, args["port"], model=model, device="cpu")
    ps.cfg = cfg
    ps._forward = recorded(ps._forward, "port", lambda a: a.cpu().numpy())
    ps.run()
    assert stub.rendered == list(range(N_VIEWS))
    return str(tmp_path / "jax"), str(tmp_path / "port"), calls


def artifact(root, view, name):
    path = os.path.join(root, f"{view:03}", OUT, name)
    if name.endswith(".npy"):
        return np.load(path)
    return np.asarray(Image.open(path))


def test_stage_host_logic_matches_jax_exactly(tmp_path, pairs, model):
    """The JAX stage on the port's forward against the port's stage, warm
    start on: every artifact equal, PNGs decoded pixel for pixel."""
    jroot, proot, calls = stages(tmp_path, pairs, model, warm=True,
                                 jax_forward=False)
    for j, p in zip(calls["jax"], calls["port"]):
        for a, b in zip(j, p):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert calls["port"][0][2] is None and calls["port"][1][2] is not None
    for view in range(N_VIEWS):
        names = sorted(os.listdir(os.path.join(proot, f"{view:03}", OUT)))
        assert names == ARTIFACTS
        assert sorted(os.listdir(os.path.join(jroot, f"{view:03}", OUT))) \
            == ARTIFACTS
        for name in ARTIFACTS:
            a, b = artifact(proot, view, name), artifact(jroot, view, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f"{view} {name}")
        d = artifact(proot, view, "disparity_LR.npy")
        assert d.dtype == np.float32 and d.shape == (H, W)
        assert artifact(proot, view, "occlusion_mask.npy").dtype == bool
        np.testing.assert_array_equal(
            artifact(proot, view, "depth.npy"), (80.0 + view) * 0.07 / d)


def knife_edges(d_lr, d_rl, tol, threshold):
    """Pixels where a disparity within tol could flip the occlusion mask:
    x - d_LR near an integer (the int32 truncation), or the reprojection
    gap near the threshold."""
    x = np.arange(d_lr.shape[1])[None, :]
    proj = x - d_lr
    near_int = np.abs(proj - np.round(proj)) <= tol
    xp = np.clip(proj.astype(np.int32), 0, d_lr.shape[1] - 1)
    rep = xp + d_rl[np.arange(d_lr.shape[0])[:, None], xp]
    gap = np.abs(x - np.clip(rep, 0, d_lr.shape[1] - 1))
    return near_int | (np.abs(gap - threshold) <= 2 * tol)


def test_stage_matches_jax(tmp_path, pairs, model):
    """Each package's own forward, cold views (warm start off). The padded,
    flipped batches must be equal; each view's disparity within
    tests/test_torch_stereo.py's forward_limit of JAX's and of the port's
    float64 forward on the same batch; the occlusion mask equal
    except where a disparity lies within that tolerance of an integer step
    or of the threshold, and its PNG equal where the masks are; the other
    PNGs equal on 98% of the pixels, the disparities' others within one
    colormap step (depth = fx·b/d and the shading, 1/|grad depth|, magnify
    a disparity's error without bound where d is small)."""
    jroot, proot, calls = stages(tmp_path, pairs, model, warm=False,
                                 jax_forward=True)
    m64 = copy.deepcopy(model).double()
    lut_step = int(np.ceil(np.abs(np.diff(jet_lut(), axis=0)).max() * 255))
    for view, (j, p) in enumerate(zip(calls["jax"], calls["port"])):
        for a, b in zip(j[:3], p[:3]):            # image1, image2, flow_init
            assert (a is None and b is None) or np.array_equal(a, b)
        with torch.inference_mode():
            _, exact = dlnr_forward(m64, torch.from_numpy(p[0]).double(),
                                    torch.from_numpy(p[1]).double(),
                                    DLNRConfig(iters=ITERS))
        exact = exact.numpy()
        scale = float(np.abs(exact).max())
        tol = forward_limit(j[4], exact)
        assert np.abs(p[4] - j[4]).max() / scale <= tol, view
        assert np.abs(p[4] - exact).max() / scale <= tol, view

        disp = {}
        for name in ("disparity_LR.npy", "disparity_RL.npy"):
            a, b = artifact(proot, view, name), artifact(jroot, view, name)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= tol * scale, (view, name)
            disp[name] = b
        mask_p = artifact(proot, view, "occlusion_mask.npy")
        mask_j = artifact(jroot, view, "occlusion_mask.npy")
        assert mask_p.dtype == mask_j.dtype == bool
        edge = knife_edges(disp["disparity_LR.npy"], disp["disparity_RL.npy"],
                           tol * scale, 3)
        assert not np.any((mask_p != mask_j) & ~edge), view
        a = artifact(proot, view, "occlusion_mask.png")
        b = artifact(jroot, view, "occlusion_mask.png")
        assert a.shape == b.shape == (H, W, 3)
        assert not np.any(np.any(a != b, -1) & (mask_p == mask_j)), view
        depth = artifact(jroot, view, "depth.npy")
        assert artifact(proot, view, "depth.npy").dtype == depth.dtype
        for name in ("disparity_LR.png", "disparity_RL.png", "depth.png",
                     "shading.png"):
            a = artifact(proot, view, name).astype(int)
            b = artifact(jroot, view, name).astype(int)
            assert a.shape == b.shape, name
            assert np.mean(np.any((a != b).reshape(H, W, -1), -1)) <= 0.02
            if name.startswith("disparity"):
                assert np.abs(a - b).max() <= lut_step, (view, name)


def test_stereo_defaults_and_no_cuda_fallback(monkeypatch, tmp_path):
    for ds in ("custom", "DTU", "TNT", "MobileBrick", "MipNerf360"):
        a, j = PipelineArgs.for_dataset(ds), JArgs.for_dataset(ds)
        for f in ("stereo_model", "stereo_occlusion_threshold", "stereo_warm",
                  "stereo_shading_eps"):
            assert getattr(a, f) == getattr(j, f), (ds, f)
    assert DEFAULT_VALUES["stereo_warm"] == JDEFAULTS["stereo_warm"]
    assert DISPARITY_SIGNS == JSIGNS
    args = PipelineArgs.for_dataset("DTU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Stereo(str(tmp_path), StubRenderer(str(tmp_path)), args)
    with pytest.raises(ValueError):
        Stereo(str(tmp_path), StubRenderer(str(tmp_path)),
               PipelineArgs.for_dataset("DTU", stereo_model="RAFT"),
               device="cpu")


def test_stage_loads_checkpoint_lazily(tmp_path, pairs, model):
    """No weights: the checkpoint under base_dir/checkpoints is read on the
    first run(), not before."""
    shutil.copytree(pairs, tmp_path / "views")
    stage = Stereo(str(tmp_path), StubRenderer(str(tmp_path / "views")),
                   PipelineArgs.for_dataset("custom"), device="cpu")
    stage.cfg = DLNRConfig(iters=1)
    assert stage.model is None
    os.makedirs(tmp_path / "checkpoints")
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               str(tmp_path / "checkpoints" / "DLNR_Middlebury.pth"))
    stage.run(start=N_VIEWS - 1)
    assert isinstance(stage.model, DLNR)
    assert os.path.exists(tmp_path / "views" / f"{N_VIEWS - 1:03}" / OUT /
                          "depth.npy")
    assert not os.path.exists(tmp_path / "views" / "000" / OUT)
    loaded = load_torch_checkpoint(str(tmp_path / "checkpoints" /
                                       "DLNR_Middlebury.pth"))
    assert torch.equal(loaded.update_block.mask[2].weight,
                       model.update_block.mask[2].weight)


def test_jet_matches_matplotlib():
    np.testing.assert_array_equal(
        jet_lut(), matplotlib.colormaps["jet"](np.arange(256))[:, :3])
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 4096),
                        np.arange(257) / 256, [0.0, 1.0, -0.3, 1.7, np.nan]])
    for dtype in (np.float32, np.float64):
        xs = x.astype(dtype)
        want = matplotlib.colormaps["jet"](xs)[:, :3]
        np.testing.assert_array_equal(jet(xs), want)
        np.testing.assert_array_equal((jet(xs) * 255).astype(np.uint8),
                                      (want * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(57, 83), (3, 3), (1, 5)])
def test_get_shading_matches_cv2_sobel(shape):
    rng = np.random.default_rng(shape[0])
    depth = rng.uniform(1.0, 5.0, shape).astype(np.float32)
    gx = cv2.Sobel(depth, cv2.CV_64F, 1, 0)
    gy = cv2.Sobel(depth, cv2.CV_64F, 0, 1)
    want = 1.0 / np.sqrt(gx ** 2 + gy ** 2 + 1e-4)
    got = get_shading(depth, 1e-4)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_gray_png_decodes_in_pil(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (17, 23), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


# ---------------------------------------------------------------- dlnr_eval
# Mirrors tests/test_dlnr_eval.py for the port's harness.

def test_epe_d1_semantics():
    gt = np.array([[1.0, 2.0, 4.0, np.inf],
                   [0.0, 3.0, 3.0, 5.0]], np.float32)
    pred = np.array([[1.5, 2.0, 1.0, 9.0],
                     [7.0, 3.0, 5.5, 5.0]], np.float32)
    valid = np.isfinite(gt) & (gt > 0)
    m = epe_d1(pred, gt, valid, bad_px=2.0)
    assert m == jeval.epe_d1(pred, gt, valid, bad_px=2.0)
    # valid errors: |.5|, 0, 3, 0, 2.5, 0 -> epe 1.0, >2px: 2/6
    assert m["valid_px"] == 6
    assert m["epe"] == pytest.approx(1.0)
    assert m["d1"] == pytest.approx(2 / 6)
    assert np.isnan(epe_d1(pred, gt, np.zeros_like(valid), 2.0)["epe"])


@pytest.mark.parametrize("header", [b"Pf", b"PF"])
def test_pfm_roundtrip(tmp_path, header):
    rng = np.random.default_rng(0)
    shape = (7, 5) if header == b"Pf" else (7, 5, 3)
    d = rng.normal(size=shape).astype(np.float32)
    p = str(tmp_path / "disp0GT.pfm")
    with open(p, "wb") as f:
        f.write(header + b"\n# comment\n5 7\n-1.0\n")
        np.flipud(d).astype("<f4").tofile(f)
    got = read_pfm(p)
    np.testing.assert_array_equal(got, d)
    np.testing.assert_array_equal(got, jeval.read_pfm(p))


def test_evaluate_folder_runs_end_to_end(tmp_path, model):
    """The folder evaluation over a tiny synthetic pair set through the
    port's DLNR (random weights: the harness's plumbing, not the network's
    quality)."""
    rng = np.random.default_rng(1)
    for name in ("pair_a", "pair_b"):
        d = tmp_path / name
        os.makedirs(d)
        img = rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)
        Image.fromarray(img).save(d / "im0.png")
        Image.fromarray(np.roll(img, 3, axis=1)).save(d / "im1.png")
        gt = np.full((48, 64), 3.0, np.float32)
        with open(d / "disp0GT.pfm", "wb") as f:
            f.write(b"Pf\n64 48\n-1.0\n")
            np.flipud(gt).astype("<f4").tofile(f)
    os.makedirs(tmp_path / "pair_c")                       # no files: skipped
    s = evaluate_folder(model, str(tmp_path), iters=2, bad_px=2.0,
                        verbose=False, device="cpu")
    assert s["pairs"] == 2
    assert np.isfinite(s["epe"]) and np.isfinite(s["d1_pct"])
    assert all(m["valid_px"] == 48 * 64 for m in s["per_pair"])
    # The same pair through dlnr_forward directly gives the same EPE.
    img0 = np.asarray(Image.open(tmp_path / "pair_a" / "im0.png"), np.float32)
    img1 = np.asarray(Image.open(tmp_path / "pair_a" / "im1.png"), np.float32)
    a, b = (torch.from_numpy(np.pad(i.transpose(2, 0, 1)[None],
                                    ((0, 0), (0, 0), (8, 8), (0, 0)),
                                    mode="edge")) for i in (img0, img1))
    with torch.inference_mode():
        _, disp = dlnr_forward(model, a, b, DLNRConfig(iters=2))
    epe = float(np.abs(-disp[0, 0, 8:-8].numpy() - 3.0).mean())
    assert s["per_pair"][0]["epe"] == pytest.approx(epe, rel=1e-6)

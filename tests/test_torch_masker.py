"""The port's SAM2 masker (gs2mesh_torch.pipeline.masker_stage.SAM2Masker,
init_predictor) and run_single's automask branch against the JAX package's,
on the CPU.

Both maskers get the same seeded tiny/128 SAM2 (tests/test_torch_sam2.py's
perturbed weights with the object gate open; JAX's through its own
``convert_sam2_state_dict``) and read the same left.png views. Limits: the
masks (``left_mask.npy`` and the PNG's pixels) equal; after the automask
branch of the resume pass, the cleaned meshes with equal faces and vertices
within 1e-6, the limit of tests/test_torch_run_single.py.
"""

import os

import numpy as np
import pytest
import torch

from gs2mesh_tpu.pipeline import masker_stage as jmasker
from gs2mesh_tpu.pipeline import config as jconfig
from gs2mesh_tpu.pipeline import run_single as jrs
from gs2mesh_tpu.sam2 import SAM2Config as JConfig
from gs2mesh_tpu.sam2 import convert as jconvert
from gs2mesh_torch.core.ply import read_ply
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.pipeline import config
from gs2mesh_torch.pipeline import masker_stage
from gs2mesh_torch.pipeline import run_single as rs
from gs2mesh_torch.sam2 import SAM2, SAM2Config, load_weights
from tests.test_torch_run_single import (_resume_args, _stage_resume_tree,
                                         scene_tree)  # noqa: F401 (fixture)
from tests.test_torch_sam2 import IMG, perturbed_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    sd = perturbed_state(seed=2)
    net = load_weights(SAM2(SAM2Config.tiny(IMG)), sd).eval()
    return net, jconvert.convert_sam2_state_dict(sd)


class Views:
    """The renderer surface a masker uses: NNN/ folders holding left.png."""

    def __init__(self, root, n, h=72, w=96, seed=0):
        self.root = root
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for i in range(n):
            img = base.copy()
            img[16 + 2 * i:52 + 2 * i, 20 + 3 * i:60 + 3 * i] = (220, 60, 30)
            os.makedirs(self.render_folder_name(i))
            write_png(os.path.join(self.render_folder_name(i), "left.png"),
                      img)
        self.n = n

    def __len__(self):
        return self.n

    def render_folder_name(self, i):
        return os.path.join(self.root, f"{i:03}")


@pytest.mark.parametrize("prompt", [
    {}, {"box": np.array([18.0, 14.0, 62.0, 54.0])},
    {"points": np.array([[40.0, 30.0], [5.0, 5.0]]),
     "labels": np.array([1, 0])}])
def test_segment_matches_jax(tmp_path, weights, prompt):
    net, jparams = weights
    masks = {}
    for side in ("port", "jax"):
        views = Views(str(tmp_path / side), 3)
        if side == "port":
            m = masker_stage.SAM2Masker(views, sam2_model=net, device="cpu",
                                        **prompt)
        else:
            m = jmasker.SAM2Masker(views, sam2_params=jparams,
                                   sam2_cfg=JConfig.tiny(image_size=IMG),
                                   **prompt)
        m.segment()
        masks[side] = [(np.load(os.path.join(views.render_folder_name(i),
                                             "left_mask.npy")),
                        read_png(os.path.join(views.render_folder_name(i),
                                              "left_mask.png")))
                       for i in range(3)]
    fill = []
    for (pn, pp), (jn, jp) in zip(masks["port"], masks["jax"]):
        assert pn.dtype == np.bool_ and pn.shape == (72, 96)
        np.testing.assert_array_equal(pn, jn)
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pp, pn.astype(np.uint8) * 255)
        fill.append(pn.mean())
    assert 0 < np.mean(fill) < 1


def test_preview_mask_matches_jax(tmp_path, weights):
    net, jparams = weights
    views = Views(str(tmp_path), 1)
    img = read_png(os.path.join(views.render_folder_name(0), "left.png"))
    port = masker_stage.SAM2Masker(views, sam2_model=net, device="cpu")
    ref = jmasker.SAM2Masker(views, sam2_params=jparams,
                             sam2_cfg=JConfig.tiny(image_size=IMG))
    kw = dict(points=np.array([[40.0, 30.0]]), labels=np.array([1]))
    np.testing.assert_array_equal(port.preview_mask(img, **kw),
                                  ref.preview_mask(img, **kw))


def test_checkpoint_presets_and_errors(tmp_path, weights, monkeypatch):
    """The preset comes from the checkpoint's name as in JAX; no weights
    raise the same ValueError in both packages (JAX's init_predictor passes
    no checkpoint); a GroundingDINO checkpoint that is not there gives no
    box, as in JAX (segment() then takes the whole-image box)."""
    views = Views(str(tmp_path / "v"), 1)
    path = str(tmp_path / "sam2_hiera_tiny.pt")
    torch.save({"model": net_state(weights)}, path)
    m = masker_stage.SAM2Masker(views, sam2_checkpoint=path, device="cpu")
    assert m.predictor.cfg == SAM2Config.tiny()
    args = config.PipelineArgs.for_dataset("custom")
    with pytest.raises(ValueError, match="sam2_checkpoint"):
        jmasker.init_predictor(str(tmp_path), views, args)
    with pytest.raises(ValueError, match="sam2_checkpoint"):
        masker_stage.init_predictor(str(tmp_path), views, args, device="cpu")
    m = masker_stage.SAM2Masker(views, sam2_model=weights[0], device="cpu",
                                gdino_checkpoint="groundingdino.pth")
    frame = read_png(os.path.join(views.render_folder_name(0), "left.png"))
    assert m._gdino_box(frame) is None
    assert jmasker.SAM2Masker(
        views, sam2_params=weights[1], sam2_cfg=JConfig.tiny(image_size=IMG),
        gdino_checkpoint="groundingdino.pth")._gdino_box(frame) is None
    # The reference's checkpoint location under base_dir is found, and its
    # name picks the large preset.
    default = os.path.join(str(tmp_path), masker_stage.SAM2_CHECKPOINT)
    os.makedirs(os.path.dirname(default))
    os.replace(path, default)
    loads = []

    def load(p, cfg):
        loads.append((p, cfg))
        return weights[0]

    import gs2mesh_torch.sam2 as psam2
    monkeypatch.setattr(psam2, "load_sam2_checkpoint", load)
    masker_stage.init_predictor(str(tmp_path), views, args, device="cpu")
    assert loads == [(default, SAM2Config.large())]


def net_state(weights):
    return weights[0].state_dict()


def test_run_single_automask_matches_jax(tmp_path, scene_tree, weights,
                                         monkeypatch):
    """The custom scene's resume pass with masker_automask: init_predictor
    patched in both packages to a factory of the same seeded SAM2; the
    branch segments every view and turns TSDF_use_mask on."""
    net, jparams = weights
    monkeypatch.setattr(jrs, "init_predictor",
                        lambda base_dir, renderer, args: jmasker.SAM2Masker(
                            renderer, sam2_params=jparams,
                            sam2_cfg=JConfig.tiny(image_size=IMG)))
    monkeypatch.setattr(rs, "init_predictor",
                        lambda base_dir, renderer, args, device: (
                            masker_stage.SAM2Masker(renderer, sam2_model=net,
                                                    device=device)))
    out = {}
    for side, cfg_mod, run, kw in (
            ("jax", jconfig, jrs.run_single, {}),
            ("port", config, rs.run_single, {"device": "cpu"})):
        base = str(tmp_path / side)
        args = _resume_args(cfg_mod, "custom", "synth")
        args.masker_automask = True
        args.TSDF_use_mask = False
        cams = _stage_resume_tree(base, scene_tree, "custom", "synth", args)
        path = run(args, base_dir=base, pair_capacity=1 << 15, **kw)
        assert args.TSDF_use_mask
        root = os.path.dirname(path)
        out[side] = (read_ply(path), [np.load(os.path.join(
            root, f"{i:03}", "left_mask.npy")) for i in range(len(cams))],
            os.path.relpath(path, base))
    (pm, pmasks, ppath), (jm, jmasks, jpath) = out["port"], out["jax"]
    assert ppath == jpath
    for a, b in zip(pmasks, jmasks):
        np.testing.assert_array_equal(a, b)
    assert 0 < np.mean([m.mean() for m in pmasks]) < 1
    assert len(pm.faces) > 100
    np.testing.assert_array_equal(pm.faces, jm.faces)
    np.testing.assert_allclose(pm.positions, jm.positions, rtol=0, atol=1e-6)

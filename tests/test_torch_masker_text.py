"""The masking stage's text prompt and interactive seeding in the port
(``SAM2Masker`` with a GroundingDINO checkpoint, ``init_predictor``,
``pipeline/masker_ui.py``) against the JAX package's, on the CPU.

Both maskers get the same files: a ``.pth`` of the seeded small
GroundingDINO of tests/test_torch_gdino.py in the released layout (JAX's
masker reads it with its own ``convert_gdino_checkpoint``; both packages'
loaders are given the small config, as theirs is the full one), the same
vocab.txt, the same seeded tiny/128 SAM2 (tests/test_torch_masker.py) and
the same left.png views, 32 x 400 (the 1,333 cap makes GroundingDINO's
input 96 x 1344). Limits: the view-0 box within 1e-5 of its largest
coordinate, the masks (``left_mask.npy`` and the PNG) equal on every view;
the seeder's seeds equal after every scripted event.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

import gs2mesh_tpu.gdino as jgdino
import gs2mesh_torch.gdino as pgdino
from gs2mesh_tpu.pipeline import masker_stage as jmasker
from gs2mesh_tpu.pipeline import masker_ui as jui
from gs2mesh_tpu.sam2 import SAM2Config as JConfig
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.gdino import released_state_dict
from gs2mesh_torch.pipeline import config, masker_stage
from gs2mesh_torch.pipeline import masker_ui as ui
from tests.test_torch_gdino import jax_cfg, perturbed_state, small_cfg
from tests.test_torch_gdino_io import write_vocab
from tests.test_torch_masker import Views, weights  # noqa: F401 (fixture)
from tests.test_torch_sam2 import IMG

H, W = 32, 400


@pytest.fixture(scope="module")
def gdino_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gdino")
    cfg = small_cfg()
    path = str(root / "groundingdino_small.pth")
    torch.save({"model": released_state_dict(perturbed_state(cfg, seed=4),
                                             cfg, prefix="module.")}, path)
    return path, write_vocab(root / "vocab.txt"), cfg


def make_masker(side, views, weights, files, monkeypatch, **kw):
    """A port or JAX SAM2Masker on the test's files; its _gdino_box calls
    are recorded in .boxes."""
    net, jparams = weights
    path, vocab, cfg = files
    if side == "port":
        monkeypatch.setattr(pgdino, "load_gdino_checkpoint", functools.partial(
            pgdino.load_gdino_checkpoint, cfg=cfg))
        m = masker_stage.SAM2Masker(views, sam2_model=net, device="cpu",
                                    gdino_checkpoint=path, gdino_vocab=vocab,
                                    **kw)
    else:
        monkeypatch.setattr(jgdino, "predict", functools.partial(
            jgdino.predict, cfg=jax_cfg(cfg)))
        m = jmasker.SAM2Masker(views, sam2_params=jparams,
                               sam2_cfg=JConfig.tiny(image_size=IMG),
                               gdino_checkpoint=path, gdino_vocab=vocab, **kw)
    m.boxes = []
    find = m._gdino_box

    def record(img):
        m.boxes.append(find(img))
        return m.boxes[-1]

    m._gdino_box = record
    return m


def masks(views):
    out = []
    for i in range(len(views)):
        d = views.render_folder_name(i)
        npy = np.load(os.path.join(d, "left_mask.npy"))
        png = read_png(os.path.join(d, "left_mask.png"))
        np.testing.assert_array_equal(png, npy.astype(np.uint8) * 255)
        out.append(npy)
    return out


@pytest.mark.parametrize("box_threshold", [0.35, 0.0])
def test_text_prompt_box_matches_jax(tmp_path, weights, gdino_files,
                                     monkeypatch, box_threshold):
    got = {}
    for side in ("port", "jax"):
        views = Views(str(tmp_path / side), 3, h=H, w=W)
        m = make_masker(side, views, weights, gdino_files, monkeypatch,
                        prompt="Main_Object", box_threshold=box_threshold)
        m.segment()
        got[side] = (m.boxes, masks(views))
    (pboxes, pmasks), (jboxes, jmasks) = got["port"], got["jax"]
    assert len(pboxes) == len(jboxes) == 1
    pbox, jbox = pboxes[0], jboxes[0]
    print("view-0 box", pbox, jbox)
    # A threshold of 0 keeps every query: the random net always gives a box.
    assert (pbox is None) == (jbox is None) == (box_threshold > 0.3)
    if pbox is not None:
        assert pbox.shape == (4,) and np.isfinite(pbox).all()
        np.testing.assert_allclose(pbox, jbox, rtol=0,
                                   atol=1e-5 * np.abs(jbox).max())
    for a, b in zip(pmasks, jmasks):
        assert a.shape == (H, W)
        np.testing.assert_array_equal(a, b)


def test_missing_checkpoint_gives_whole_image_box(tmp_path, weights,
                                                  gdino_files, monkeypatch):
    """No file at gdino_checkpoint: no box from GroundingDINO in either
    package, the whole-image box (the masks of a masker without one)."""
    files = (str(tmp_path / "missing.pth"),) + gdino_files[1:]
    got = {}
    for side in ("port", "jax", "none"):
        views = Views(str(tmp_path / side), 2, h=H, w=W)
        if side == "none":
            masker_stage.SAM2Masker(views, sam2_model=weights[0],
                                    device="cpu").segment()
        else:
            m = make_masker(side, views, weights, files, monkeypatch)
            m.segment()
            assert m.boxes == [None]
        got[side] = masks(views)
    for p, j, n in zip(got["port"], got["jax"], got["none"]):
        np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(p, n)


def test_init_predictor_passes_checkpoint(tmp_path, weights, gdino_files):
    path, vocab, cfg = gdino_files
    views = Views(str(tmp_path), 1, h=H, w=W)
    args = config.PipelineArgs.for_dataset("custom")
    args.masker_prompt = "red car"
    m = masker_stage.init_predictor(str(tmp_path), views, args,
                                    gdino_checkpoint=path, device="cpu",
                                    sam2_model=weights[0], gdino_vocab=vocab)
    j = jmasker.init_predictor(str(tmp_path), views, args,
                               gdino_checkpoint=path,
                               sam2_params=weights[1],
                               sam2_cfg=JConfig.tiny(image_size=IMG))
    assert m._gdino_ckpt == j._gdino_ckpt == path
    assert m.prompt == j.prompt == "red car"
    assert (m.box_threshold, m.text_threshold) == (0.35, 0.25)


# ------------------------------------------------------------------ seeder

class Stub:
    """Accepts any call or attribute (a stand-in for matplotlib's figure,
    axes and canvas); records the canvas callbacks."""

    def __init__(self):
        self.callbacks = {}

    def mpl_connect(self, name, fn):
        self.callbacks[name] = fn

    def __getattr__(self, name):
        if name == "canvas":
            return self
        return lambda *a, **k: None


def event(ax, x, y, button):
    return types.SimpleNamespace(inaxes=ax, xdata=x, ydata=y, button=button)


def script(ax):
    """(press, release) pairs: clicks, a drag box, right-click, middle-
    clicks on a box edge and on a point, a click outside the axes, a
    replacing box, a short drag (a click), a release outside the axes."""
    return [
        (event(ax, 40.0, 12.0, 1), event(ax, 41.0, 12.5, 1)),    # +point
        (event(ax, 300.0, 20.0, 3), event(ax, 300.0, 20.0, 3)),  # -point
        (event(ax, 10.0, 4.0, 1), event(ax, 200.0, 28.0, 1)),    # box
        (event(ax, 120.0, 16.0, 1), event(ax, 121.0, 17.0, 1)),  # +point
        (event(ax, 199.0, 16.0, 2), event(ax, 199.0, 16.0, 2)),  # box edge
        (event(ax, 118.0, 15.0, 2), event(ax, 118.0, 15.0, 2)),  # a point
        (event(None, 50.0, 10.0, 1), event(None, 50.0, 10.0, 1)),  # outside
        (event(ax, 30.0, 2.0, 1), event(ax, 250.0, 30.0, 1)),    # box
        (event(ax, 60.0, 8.0, 1), event(ax, 63.0, 10.0, 1)),     # drag < 5
        (event(ax, 5.0, 5.0, 2), event(ax, 5.0, 5.0, 2)),        # top edge
        (event(ax, 250.0, 25.0, 1), event(None, 10.0, 10.0, 1)),  # leaves
    ]


def seeds_equal(a, b):
    for x, y in zip(a.seeds(), b.seeds()):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("with_axes", [False, True])
def test_seeder_matches_jax(with_axes):
    image = np.zeros((H, W, 3), np.uint8)
    calls = {"port": [], "jax": []}

    def preview(side):
        def fn(img, pts, lbl, box):
            calls[side].append((None if pts is None else pts.copy(), lbl,
                                None if box is None else box.copy()))
            return np.ones(img.shape[:2], bool)
        return fn

    port = ui.InteractiveSeeder(image, preview("port"))
    ref = jui.InteractiveSeeder(image, preview("jax"))
    ax = Stub()
    if with_axes:
        for s in (port, ref):
            s.fig, s.ax = Stub(), ax
    for press, release in script(ax):
        for s in (port, ref):
            s.on_click(press)
            s.on_release(release)
        seeds_equal(port, ref)
    pts, lbl, _ = port.seeds()
    # The click outside the axes counts only where there are no axes.
    assert list(lbl) == [1, 0, 1] + [1] * (not with_axes)
    assert len(calls["port"]) == len(calls["jax"]) > 0
    for a, b in zip(calls["port"], calls["jax"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def stub_pyplot(monkeypatch, events):
    """A matplotlib.pyplot whose show() plays ``events`` through the
    figure's callbacks."""
    import matplotlib

    fig, ax = Stub(), Stub()
    plt = types.ModuleType("matplotlib.pyplot")
    plt.subplots = lambda **kw: (fig, ax)

    def show(block=True):
        for press, release in events(ax):
            fig.callbacks["button_press_event"](press)
            fig.callbacks["button_release_event"](release)

    plt.show = show
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", plt)
    monkeypatch.setattr(matplotlib, "pyplot", plt, raising=False)


def test_run_interactive_masker_matches_jax(tmp_path, weights, monkeypatch):
    net, jparams = weights
    stub_pyplot(monkeypatch, lambda ax: script(ax)[:4])
    got = {}
    for side in ("port", "jax"):
        views = Views(str(tmp_path / side), 3, h=H, w=W)
        if side == "port":
            m = masker_stage.SAM2Masker(views, sam2_model=net, device="cpu")
            seeder = ui.run_interactive_masker(views, m)
        else:
            m = jmasker.SAM2Masker(views, sam2_params=jparams,
                                   sam2_cfg=JConfig.tiny(image_size=IMG))
            seeder = jui.run_interactive_masker(views, m)
        got[side] = (seeder, m, masks(views))
    (ps, pm, pmasks), (js, jm, jmasks) = got["port"], got["jax"]
    seeds_equal(ps, js)
    assert ps.mask is not None and ps.mask.shape == (H, W)
    np.testing.assert_array_equal(ps.mask, js.mask)
    np.testing.assert_array_equal(pm.box, jm.box)
    np.testing.assert_array_equal(pm.points, jm.points)
    for a, b in zip(pmasks, jmasks):
        np.testing.assert_array_equal(a, b)
    assert 0 < np.mean([a.mean() for a in pmasks]) < 1

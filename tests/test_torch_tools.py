"""The port's viz and utils (gs2mesh_torch.viz, gs2mesh_torch.utils), held
to the JAX package's: frustum segments, the stereo results panel (byte for
byte against JAX's PIL panel), the matplotlib plots, StageTimer /
MetricLogger files, check_finite_tree's paths, guard_render's dump, and
the profiler and timing scopes."""

from __future__ import annotations

import collections
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from gs2mesh_torch import viz
from gs2mesh_torch.core.png import read_png, write_png
from gs2mesh_torch.utils import (MetricLogger, StageTimer, check_finite_tree,
                                 debug_dump, profile_trace, time_block)
from gs2mesh_torch.utils.debug import guard_render


def random_poses(n, seed=0):
    from gs2mesh_torch.core.transforms import convert_R_T_to_GS

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R, T = convert_R_T_to_GS(rng.uniform(-60, 60, 3), rng.uniform(-3, 3,
                                                                     3))
        P = np.eye(4)
        P[:3, :3], P[:3, 3] = R.T, T
        out.append(P)
    return np.stack(out)


@pytest.mark.parametrize("depth,aspect", [(0.2, 1.333), (0.5, 0.75)])
def test_camera_frustum_segments_match_jax(depth, aspect):
    from gs2mesh_tpu import viz as jviz

    for P in random_poses(4):
        c2w = np.linalg.inv(P)
        got = viz.camera_frustum_segments(c2w, depth, aspect)
        assert got.shape == (8, 2, 3)
        np.testing.assert_array_equal(
            got, jviz.camera_frustum_segments(c2w, depth, aspect))


def write_results(d, model_name="DLNR", h=24, w=40, seed=0, skip=()):
    """The six files view_results_panel reads: RGB views, 8-bit grayscale
    masks and an RGBA shading image."""
    rng = np.random.default_rng(seed)
    files = {"left.png": (h, w, 3), "right.png": (h, w, 3),
             "left_mask.png": (h, w),
             f"out_{model_name}/occlusion_mask.png": (h, w),
             f"out_{model_name}/disparity_LR.png": (h, w, 3),
             f"out_{model_name}/shading.png": (h, w, 4)}
    os.makedirs(os.path.join(d, f"out_{model_name}"), exist_ok=True)
    for rel, shape in files.items():
        if rel not in skip:
            write_png(os.path.join(d, rel),
                      rng.integers(0, 256, shape, dtype=np.uint8))


def test_view_results_panel_equals_jax_pil_panel(tmp_path):
    from gs2mesh_tpu import viz as jviz

    write_results(str(tmp_path))
    panel = viz.view_results_panel(str(tmp_path), "DLNR",
                                   save_path=str(tmp_path / "panel.png"))
    jpanel = np.asarray(jviz.view_results_panel(str(tmp_path), "DLNR"))
    assert panel.dtype == np.uint8 and panel.shape == (24, 5 * 40, 3)
    np.testing.assert_array_equal(panel, jpanel)
    np.testing.assert_array_equal(read_png(str(tmp_path / "panel.png")),
                                  panel)


def test_blend_equals_pil_blend():
    from PIL import Image

    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
            for _ in range(2))
    for alpha in (0.5, 0.3, 0.77):
        ref = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b),
                                     alpha))
        np.testing.assert_array_equal(viz.blend(a, b, alpha), ref)


def test_view_results_panel_seeded_fill(tmp_path):
    write_results(str(tmp_path), skip=("left_mask.png",))
    one = viz.view_results_panel(str(tmp_path), "DLNR",
                                 rng=np.random.default_rng(4))
    two = viz.view_results_panel(str(tmp_path), "DLNR",
                                 rng=np.random.default_rng(4))
    np.testing.assert_array_equal(one, two)
    fill = one[:, 40:80]
    assert fill.shape == (24, 40, 3) and fill.max() < 255


def test_matplotlib_plots_write_their_files(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setattr(viz, "_have_plotly", lambda: False)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3000, 3))
    poses = random_poses(3)
    viz.visualize_poses(poses[:, :3], pts, inside_mask=pts[:, 2] > 0,
                        show=False, save_path=str(tmp_path / "poses.png"))
    viz.visualize_mesh(pts, gt_points=pts * 1.1, show=False,
                       save_path=str(tmp_path / "mesh.png"))
    for f in ("poses.png", "mesh.png"):
        img = read_png(str(tmp_path / f))
        assert img.ndim == 3 and img.shape[0] > 100


def fake_clock(monkeypatch):
    """time.perf_counter stepping 0.25 s a call (both packages read it)."""
    ticks = iter(np.arange(0.0, 1000.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def test_stage_timer_and_metric_logger_files_equal_jax(tmp_path,
                                                       monkeypatch):
    from gs2mesh_tpu.utils import MetricLogger as JLogger
    from gs2mesh_tpu.utils import StageTimer as JTimer

    outs = {}
    for tag, timer_cls, logger_cls in (("port", StageTimer, MetricLogger),
                                       ("jax", JTimer, JLogger)):
        fake_clock(monkeypatch)
        t = timer_cls()
        for name in ("render", "stereo", "render", "tsdf"):
            with t.stage(name):
                pass
        t.save(str(tmp_path / tag / "stages.json"))
        log = logger_cls(str(tmp_path / tag / "metrics.jsonl"))
        log.log(1, loss=np.float32(0.5), psnr=torch.tensor(21.25))
        log.log(2, loss=0.25, n=3)
        outs[tag] = (t.report(), log.records)
    for f in ("stages.json", "metrics.jsonl"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    assert outs["port"] == outs["jax"]
    assert json.loads((tmp_path / "port" / "stages.json").read_text())[
        "render"]["count"] == 2


Pair = collections.namedtuple("Pair", "a b")


def tree(lib):
    nan, inf = float("nan"), float("inf")
    arr = (lambda x: torch.tensor(x)) if lib == "torch" else np.asarray
    return {"z": arr([1.0, nan]), "a": (arr([1.0]), [arr([inf]), 2.0]),
            "n": Pair(a=arr([[0.0, -inf]]), b=None),
            "ints": arr(np.array([1, 2])), "ok": {"x": arr([0.0])},
            "scalar": nan}


def test_check_finite_tree_paths_match_jax():
    from gs2mesh_tpu.utils import check_finite_tree as j_check

    got = check_finite_tree(tree("torch"), "out")
    assert got == j_check(tree("numpy"), "out")
    assert got == ["out['a'][1][0]", "out['n'].a", "out['scalar']",
                   "out['z']"]
    assert check_finite_tree({"x": torch.zeros(3)}) == []


def test_guard_render_dumps_then_raises(tmp_path):
    inputs = {"means3d": torch.ones(4, 3), "cfg": (1, 2.0)}
    ok = {"image": torch.zeros(3, 2, 2)}
    guard_render(inputs, ok, str(tmp_path))
    assert not os.listdir(tmp_path)
    bad = {"image": torch.full((3, 2, 2), float("nan"))}
    with pytest.raises(FloatingPointError, match=r"output\['image'\]"):
        guard_render(inputs, bad, str(tmp_path), tag="bw")
    with open(tmp_path / "snapshot_bw.dump", "rb") as f:
        blob = pickle.load(f)
    assert isinstance(blob["inputs"]["means3d"], np.ndarray)
    np.testing.assert_array_equal(blob["inputs"]["means3d"], np.ones((4, 3)))
    assert blob["inputs"]["cfg"][1] == 2.0
    assert np.isnan(blob["outputs"]["image"]).all()
    assert debug_dump(inputs, ok, str(tmp_path)).endswith("snapshot_fw.dump")


def test_profile_trace_and_time_block(tmp_path, capsys):
    from gs2mesh_torch.ops.rasterizer import RasterizerConfig, rasterize
    from tests.scenes import sphere_scene
    from tests.test_torch_core import look_at_camera

    s = sphere_scene(n=64)
    args = [torch.from_numpy(s[k]) for k in
            ("means3d", "scales", "rotations", "opacities", "shs")]
    cam = look_at_camera((0.0, 0.0, -3.0), 32, 32)
    with profile_trace(str(tmp_path / "trace")) as d:
        with time_block("render", sync=args) as t:
            out = rasterize(*args, cam, 0,
                            cfg=RasterizerConfig(pair_capacity=1 << 12))
    assert t["ms"] > 0 and "[time] render:" in capsys.readouterr().out
    assert out.image.shape == (3, 32, 32)
    (trace,) = os.listdir(d)
    events = json.loads((tmp_path / "trace" / trace).read_text())
    assert any("rasterize" in e.get("name", "") or "aten::" in
               e.get("name", "") for e in events["traceEvents"])

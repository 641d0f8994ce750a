"""examples/custom_data_walkthrough_torch.py, every cell, on the CPU.

The cells run in order (examples/run_walkthrough_torch.py) on
tests/test_run_single_e2e.py's scene, laid out as data/custom/<name>/ under
the working directory, with the e2e twin's arguments
(tests/test_torch_run_single.py::test_run_single_end_to_end): video and
COLMAP skipped, 60 GS iterations (the twin's 150 cut for time; the
limits below are the twin's), a seeded random DLNR written as
checkpoints/<stereo_model>.pth in the released layout, masking off. The
pair capacity is the twin's 1 << 15: on the CPU the plain emission walks
every slot of it, and no render of this 64x64 scene comes near it.

Checks: the cleaned mesh has the same faces as run_single's on the same
scene, arguments and seed, its vertices within 1e-6 (as the resume pass is
held); the twin's limits (view 0's left.png within L1 0.08 of its target;
after the analytic depth is written over every view, the TSDF cell's
cleaned mesh within 0.12 of the unit sphere); the panel is (H, W, 3)
uint8.
"""

import functools
import os
import shutil
import sys

import numpy as np
import torch

from gs2mesh_torch.core.ply import read_ply
from gs2mesh_torch.core.png import read_png
from gs2mesh_torch.pipeline import Renderer, config
from gs2mesh_torch.pipeline import run_single as rs
from gs2mesh_torch.stereo import DLNR, init_dlnr_
from tests.test_run_single_e2e import H, N_VIEWS, W, _synthetic_depth
from tests.test_torch_run_single import scene_tree  # noqa: F401 (fixture)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

from run_walkthrough_torch import (run_cell, run_walkthrough,  # noqa: E402
                                   walkthrough_cells)

torch.set_num_threads(1)

NAME = "sculpture"            # the Parameters cell's colmap_name
MODEL = "DLNR_Middlebury"
PAIR_CAPACITY = 1 << 15
PARAMS = dict(skip_video_extraction=True, skip_colmap=True,
              skip_masking=True, masker_automask=False, GS_iterations=60,
              GS_save_test_iterations=[60], renderer_baseline_absolute=0.15,
              TSDF_max_depth_baselines=30, TSDF_min_depth_baselines=1,
              TSDF_voxel=16, TSDF_sdf_trunc=0.2, TSDF_cleaning_threshold=10,
              TSDF_use_mask=False)


def lay_out(base, scene_tree, dlnr):
    """The scene at base/data/custom/<NAME> and the DLNR checkpoint."""
    shutil.copytree(scene_tree[0], os.path.join(base, "data", "custom", NAME))
    os.makedirs(os.path.join(base, "checkpoints"))
    torch.save({"module." + k: v for k, v in dlnr.state_dict().items()},
               os.path.join(base, "checkpoints", f"{MODEL}.pth"))


def test_walkthrough_matches_run_single(tmp_path, scene_tree, monkeypatch):
    dlnr = init_dlnr_(DLNR(), torch.Generator().manual_seed(0))
    monkeypatch.setattr(rs, "train_gs", functools.partial(
        rs.train_gs, pair_capacity=PAIR_CAPACITY))
    prepare = Renderer.prepare_renderer
    monkeypatch.setattr(Renderer, "prepare_renderer", functools.partialmethod(
        prepare, pair_capacity=PAIR_CAPACITY))

    walk = str(tmp_path / "walkthrough")
    lay_out(walk, scene_tree, dlnr)
    ns, walls, skipped = run_walkthrough(
        walk, dict(device="cpu", **PARAMS))
    titles = [t for t, _ in walkthrough_cells()]
    assert not skipped and list(walls) == titles and len(titles) == 14
    assert ns["strings"]["splatting"].endswith("_iterations60")
    panel = ns["panel"]
    assert panel.dtype == np.uint8 and panel.shape == (H, 5 * W, 3)

    # run_single with the cells' arguments, in a directory of its own.
    ref = str(tmp_path / "run_single")
    lay_out(ref, scene_tree, dlnr)
    args = config.PipelineArgs.for_dataset(
        "custom", colmap_name=NAME, video_interval=10,
        renderer_baseline_percentage=7.0, stereo_warm=False, **PARAMS)
    ref_path = rs.run_single(args, base_dir=ref, pair_capacity=PAIR_CAPACITY,
                             device="cpu")
    assert os.path.relpath(ref_path, ref) == os.path.relpath(
        ns["clean_path"], walk)
    got, want = read_ply(ns["clean_path"]), read_ply(ref_path)
    assert len(want.faces) > 0
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.positions, want.positions, rtol=0,
                               atol=1e-6)

    # The e2e twin's limits: the trained model, then the analytic depth.
    renderer = ns["renderer"]
    gt = read_png(os.path.join(walk, "data", "custom", NAME, "images",
                               "000.png")).astype(np.float32)
    left = read_png(os.path.join(renderer.render_folder_name(0),
                                 "left.png")).astype(np.float32)
    l1 = np.abs(gt - left).mean() / 255.0
    assert l1 < 0.08, f"GS training did not converge (L1={l1:.3f})"
    for i in range(N_VIEWS):
        out = os.path.join(renderer.render_folder_name(i), f"out_{MODEL}")
        np.save(os.path.join(out, "depth.npy"),
                _synthetic_depth(renderer.left_cameras[i]))
        np.save(os.path.join(out, "occlusion_mask.npy"),
                np.ones((H, W), bool))
    (tsdf_cell,) = [c for c in walkthrough_cells() if c[0].startswith("TSDF")]
    run_cell(ns, *tsdf_cell)
    verts = read_ply(ns["clean_path"]).positions
    assert verts.shape[0] > 100
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.12, np.median(radii)
    assert np.mean(np.abs(radii - 1.0)) < 0.12

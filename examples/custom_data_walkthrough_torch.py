# %% [markdown]
# # gs2mesh_torch — custom data walkthrough
#
# Interactive end-to-end reconstruction, mirroring the reference's
# custom_data.ipynb (29 cells): params → COLMAP → GS training → stereo-pair
# rendering → DLNR depth → (optional) masking → TSDF fusion → mesh, with
# visual checkpoints after each stage. Run as a notebook (`jupytext`/VS Code
# "# %%" cells) or top to bottom as a script.

# %% Parameters
import os

from gs2mesh_torch.pipeline import PipelineArgs, create_strings

base_dir = os.path.abspath(os.getcwd())
args = PipelineArgs.for_dataset("custom")
args.colmap_name = "sculpture"          # data/custom/<name>/{<name>.mp4|images/}
args.video_interval = 10                # extract every n-th frame (~3 fps)
args.renderer_baseline_percentage = 7.0
args.stereo_warm = False                # True only for sorted/ordered views
device = "cuda"                         # "cpu" runs the plain PyTorch path
strings = create_strings(args, base_dir)
colmap_dir = os.path.join(base_dir, "data", "custom", args.colmap_name)
print(strings["output_dir_root"])

# %% Extract frames from video (skip if you already have images/)
from gs2mesh_torch.sfm import extract_frames

if not args.skip_video_extraction:
    extract_frames(os.path.join(colmap_dir, f"{args.colmap_name}.{args.video_extension}"),
                   os.path.join(colmap_dir, "images"),
                   interval=args.video_interval)

# %% Run COLMAP (unknown poses; requires the colmap binary on PATH)
from gs2mesh_torch.sfm import run_colmap

if not args.skip_colmap:
    run_colmap(colmap_dir)

# %% Visualize COLMAP poses + sparse points
import numpy as np

from gs2mesh_torch.core import colmap_io
from gs2mesh_torch import viz

cams, images, points = colmap_io.read_model(os.path.join(colmap_dir, "sparse", "0"))
poses = colmap_io.poses_from_model(images)
pts = np.stack([p.xyz for p in points.values()]) if points else None
viz.visualize_poses(poses, pts, subsample=20)

# %% Train Gaussian Splatting (in-process PyTorch trainer)
from gs2mesh_torch.pipeline.run_single import train_gs

model_dir = os.path.join(base_dir, "splatting_output",
                         strings["splatting"], args.colmap_name)
trainer = train_gs(colmap_dir, model_dir, args.GS_iterations,
                   args.GS_save_test_iterations, args.GS_white_background,
                   device=device)
print("train PSNR:", trainer.report_psnr(range(4)))

# %% Initialize the stereo-pair renderer (baseline from scene radius)
from gs2mesh_torch.pipeline import Renderer

renderer = Renderer(base_dir, colmap_dir, strings["output_dir_root"], args,
                    dataset=strings["dataset"], splatting=strings["splatting"],
                    device=device)
renderer.prepare_renderer()
print("views:", len(renderer), "baseline:", renderer.baseline)

# %% Visualize renderer poses against the GS point cloud
viz.visualize_poses(renderer.poses, renderer.GS_ply_points, subsample=100)

# %% Render one stereo pair and eyeball the overlap
imgs = renderer.render_image_pair(0)
try:
    import matplotlib.pyplot as plt

    plt.imshow(imgs["left"])
    plt.imshow(imgs["right"], alpha=0.5)
    plt.show()
except Exception:
    pass

# %% Run DLNR stereo over all views (reads checkpoints/<stereo_model>.pth)
from gs2mesh_torch.pipeline import Stereo

stereo = Stereo(base_dir, renderer, args,
                ckpt_path=os.path.join(base_dir, "checkpoints",
                                       f"{args.stereo_model}.pth"),
                device=device)
stereo.run(start=0)

# %% Per-view diagnostic panel (left/right blend, masks, disparity, shading)
panel = viz.view_results_panel(renderer.render_folder_name(0),
                               args.stereo_model)
panel

# %% Optional: object masking (SAM2 + GroundingDINO checkpoints)
from gs2mesh_torch.pipeline.masker_stage import SAM2Masker

if args.masker_automask:
    # Automatic: GroundingDINO text prompt seeds the SAM2 propagation.
    masker = SAM2Masker(renderer, prompt=args.masker_prompt, device=device)
    masker.segment()
    args.TSDF_use_mask = True
elif False:  # flip to True for the notebook-style interactive seeding
    # Interactive (custom_data.ipynb contract, masker_utils.py:184-267):
    # left-click adds a positive point, right-click a negative one,
    # click-drag draws a box, middle-click removes; the SAM2 preview mask
    # redraws after every edit, and closing the window propagates the
    # seeds through the whole view sequence.
    from gs2mesh_torch.pipeline.masker_ui import run_interactive_masker

    masker = SAM2Masker(renderer, sam2_checkpoint="sam2_hiera_large.pt",
                        device=device)
    run_interactive_masker(renderer, masker)
    args.TSDF_use_mask = True

# %% TSDF fusion + mesh extraction + cleaning
from gs2mesh_torch.pipeline import TSDF

tsdf = TSDF(renderer, stereo, args, strings["TSDF"], device=device)
tsdf.run()
tsdf.save_mesh()
clean_path = tsdf.clean_mesh()
print("cleaned mesh:", clean_path)

# %% Visualize the mesh (subsampled vertex scatter, optionally vs GT)
viz.visualize_mesh(tsdf.cleaned.vertices, subsample=100)

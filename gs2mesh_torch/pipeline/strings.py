"""Experiment-name/path strings and evaluation CSV plumbing.

The port's copy of gs2mesh_tpu pipeline/strings.py (gs2mesh_utils/
eval_utils.py:23-92), byte for byte: the strings double as collision-proof
output directories and as the contract dataset evaluators use to locate
meshes. Like the JAX module, prepare_eval roots its evaluation directory at
the working directory, not at ``base_dir``.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

CSV_HEADERS = {
    "DTU": ["Scan Number", "d2s", "s2d", "f1"],
    "TNT": ["Scan Name", "Precision", "Recall", "F1 Score"],
    "MobileBrick": ["Scan Name", "Chamfer Distance", "Accuracy (2.5mm)",
                    "Recall (2.5mm)", "F1 Score (2.5mm)", "Accuracy (5mm)",
                    "Recall (5mm)", "F1 Score (5mm)"],
}


def float2str(x) -> str:
    return str(x).replace(".", "_")


def create_strings(args, base_dir: str | None = None) -> dict:
    """Formatted experiment strings (eval_utils.py:23-51)."""
    base_dir = base_dir or os.getcwd()
    splatting = (f"{args.dataset_name}"
                 f"{'_nw' if args.GS_white_background is False else ''}"
                 f"_iterations{args.GS_iterations}")
    baseline = (f"{args.renderer_baseline_absolute}a"
                if args.renderer_baseline_absolute is not None
                else f"{float2str(args.renderer_baseline_percentage)}p")
    dataset = f"{splatting}_{args.stereo_model}_baseline{baseline}"
    tsdf = (f"{args.colmap_name}_{dataset}"
            f"_mask{'1' if args.TSDF_use_mask else '0'}"
            f"_occ{'1' if args.TSDF_use_occlusion_mask else '0'}"
            f"_scale{float2str(float(args.TSDF_scale))}"
            f"_voxel{args.TSDF_voxel}_512"
            f"_trunc{args.TSDF_min_depth_baselines}"
            f"_{args.TSDF_max_depth_baselines}")
    experiment_name = (args.experiment_folder_name
                       if args.experiment_folder_name is not None else dataset)
    output_dir_root = os.path.join(
        base_dir, "output", experiment_name,
        args.renderer_folder_name if args.renderer_folder_name is not None
        else args.colmap_name)
    return {
        "splatting": splatting,
        "baseline": baseline,
        "dataset": dataset,
        "TSDF": tsdf,
        "experiment_name": experiment_name,
        "output_dir_root": output_dir_root,
        "ply_path": os.path.join(output_dir_root, f"{tsdf}_cleaned_mesh.ply"),
    }


def prepare_eval(args, base_dir: str | None = None):
    """Evaluation output dir + CSV with headers (eval_utils.py:53-75)."""
    strings = create_strings(args, base_dir)
    out_dir_prefix = os.path.join(os.getcwd(), "evaluation",
                                  args.dataset_name, "eval_output")
    Path(out_dir_prefix).mkdir(parents=True, exist_ok=True)
    exp_path = os.path.join(out_dir_prefix, strings["dataset"])
    Path(exp_path).mkdir(parents=True, exist_ok=True)
    csv_file = os.path.join(exp_path, "evaluation_results.csv")
    if not os.path.exists(csv_file):
        with open(csv_file, "w", newline="") as f:
            csv.writer(f).writerow(CSV_HEADERS[args.dataset_name])
    return strings["dataset"], exp_path, csv_file


def write_to_csv(dataset: str, csv_file: str, line) -> None:
    """Append one result row (eval_utils.py:77-92)."""
    print(list(zip(CSV_HEADERS[dataset], line)))
    with open(csv_file, "a", newline="") as f:
        csv.writer(f).writerow(line)

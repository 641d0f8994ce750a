"""Per-dataset pipeline drivers + evaluation loops.

Behavioral ports of the reference root scripts:
  run_DTU           <- run_and_evaluate_dtu.py:21-63
  run_TNT           <- run_tnt.py:12-29
  evaluate_TNT      <- evaluate_tnt.py:20-49
  run_MobileBrick   <- run_and_evaluate_mobilebrick.py:27-63
  run_MipNerf360    <- run_mipnerf360.py:12-29

Each loops over scans, offsets the GS port per scan (a multi-process
legacy knob kept for interface parity), calls run_single, then the dataset
evaluator, appending rows to evaluation_results.csv. The port's copy of
gs2mesh_tpu cli/drivers.py: ``run_kwargs`` (``device`` among them, the card
by default) go through to run_single, and run_DTU's parts run in
record_function ranges named in DTU_RANGES ("run_DTU.<name>").
"""

from __future__ import annotations

import os
from pathlib import Path

from torch.profiler import record_function

from gs2mesh_torch.pipeline.config import PipelineArgs, encode_string
from gs2mesh_torch.pipeline.run_single import run_single
from gs2mesh_torch.pipeline.strings import (create_strings, prepare_eval,
                                            write_to_csv)

DTU_RANGES = ("cull_scan", "dtu_eval")


def run_DTU(args: PipelineArgs, base_dir: str | None = None,
            **run_kwargs) -> None:
    from gs2mesh_torch.core.ply import read_ply, write_mesh_ply
    from gs2mesh_torch.evals.dtu import cull_scan, dtu_eval
    import numpy as np

    base_dir = base_dir or os.getcwd()
    official = os.path.join(base_dir, "data", "DTU", "SampleSet", "MVS_Data")
    dataset_string, exp_path, csv_file = prepare_eval(args, base_dir)
    port_orig = args.GS_port

    for scan_num in args.scans:
        args.colmap_name = f"scan{scan_num}"
        args.GS_port = port_orig + scan_num
        print(args.colmap_name)
        ply_file = run_single(args, base_dir=base_dir, **run_kwargs)
        if ply_file is None:        # a training-only rank (GS_devices > 1)
            continue

        out_dir = os.path.join(exp_path, str(scan_num))
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        with record_function("run_DTU.cull_scan"):
            d = read_ply(ply_file)
            verts = np.stack([d.vertex["x"], d.vertex["y"], d.vertex["z"]],
                             axis=1).astype(np.float64)
            faces = d.faces
            # The culling scan data lives next to the official MVS data
            # (evaluate_single_scene.py:23: scans are siblings of
            # MVS_Data/..).
            cv, cf = cull_scan(scan_num, verts, faces,
                               os.path.abspath(os.path.join(official, "..",
                                                            "..")))
            result_mesh_file = os.path.join(
                out_dir, f"{dataset_string}_scan{scan_num}.ply")
            write_mesh_ply(result_mesh_file, cv.astype(np.float32),
                           cf.astype(np.int32))
        with record_function("run_DTU.dtu_eval"):
            res = dtu_eval(cv, cf, scan_num, official, out_dir)
        write_to_csv(args.dataset_name, csv_file,
                     [scan_num, res["mean_d2s"], res["mean_s2d"],
                      res["overall"]])


def run_TNT(args: PipelineArgs, base_dir: str | None = None,
            **run_kwargs) -> None:
    """Mesh creation only; TNT evaluation runs separately (run_tnt.py)."""
    port_orig = args.GS_port
    for scan_name in args.scans:
        args.colmap_name = scan_name
        args.GS_port = port_orig + encode_string(scan_name)
        print(args.colmap_name)
        run_single(args, base_dir=base_dir, **run_kwargs)


def evaluate_TNT(args: PipelineArgs, base_dir: str | None = None) -> None:
    from gs2mesh_torch.evals.tnt import run_evaluation

    base_dir = base_dir or os.getcwd()
    _, exp_path, csv_file = prepare_eval(args, base_dir)
    for scan_name in args.scans:
        args.colmap_name = scan_name
        strings = create_strings(args, base_dir)
        scan_output_path = os.path.join(exp_path, scan_name)
        metrics = run_evaluation(
            dataset_dir=os.path.join(base_dir, "data", "TNT", scan_name),
            traj_path=os.path.join(base_dir, "data", "TNT", scan_name,
                                   f"{scan_name}_COLMAP_SfM.log"),
            ply_path=strings["ply_path"],
            out_dir=scan_output_path)
        write_to_csv(args.dataset_name, csv_file, [scan_name] + metrics)


def run_MobileBrick(args: PipelineArgs, base_dir: str | None = None,
                    **run_kwargs) -> None:
    from gs2mesh_torch.evals.mobilebrick import evaluate_single

    base_dir = base_dir or os.getcwd()
    _, exp_path, csv_file = prepare_eval(args, base_dir)
    port_orig = args.GS_port
    for scan_name in args.scans:
        args.colmap_name = scan_name
        args.GS_port = port_orig + encode_string(scan_name)
        print(args.colmap_name)
        ply_file = run_single(args, base_dir=base_dir, **run_kwargs)
        if ply_file is None:        # a training-only rank (GS_devices > 1)
            continue
        gt_dir = os.path.join(base_dir, "data", "MobileBrick", scan_name)
        out = evaluate_single(gt_dir, ply_file, exp_path, scan_name)
        write_to_csv(args.dataset_name, csv_file, [scan_name] + out)


def run_MipNerf360(args: PipelineArgs, base_dir: str | None = None,
                   **run_kwargs) -> None:
    """No official geometry GT — meshes only (run_mipnerf360.py:12-29)."""
    port_orig = args.GS_port
    for scan_name in args.scans:
        args.colmap_name = scan_name
        args.GS_port = port_orig + encode_string(scan_name)
        print(args.colmap_name)
        run_single(args, base_dir=base_dir, **run_kwargs)

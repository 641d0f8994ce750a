"""Layered CLI configuration with per-dataset default tables.

The port's copy of gs2mesh_tpu pipeline/config.py (the reference ArgParser,
gs2mesh_utils/argument_utils.py:17-142): the same ~45 flags, the same
per-dataset default tables and the same `--no-X` negative-flag convention,
as an argparse parser (the CLI) and as a plain dataclass (programmatic use).
Like the JAX parser, --TSDF_valid and --TSDF_skip parse as one string, so
the TSDF stage's view filter raises TypeError on them (ROADMAP queue C).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


def encode_string(s: str) -> int:
    """Hash a string to a 2-digit number (argument_utils.py:11)."""
    return sum(s.encode()) % 100


DATASETS = ("custom", "DTU", "TNT", "MobileBrick", "MipNerf360")

DEFAULT_VALUES = {
    "colmap_name": {"custom": "sculpture", "DTU": "scan24", "TNT": "Ignatius",
                    "MobileBrick": "aston", "MipNerf360": "garden"},
    "dataset_name": {"custom": "custom", "DTU": "DTU", "TNT": "TNT",
                     "MobileBrick": "MobileBrick", "MipNerf360": "MipNerf360"},
    "downsample": {"custom": 1, "DTU": 1, "TNT": 1, "MobileBrick": 1,
                   "MipNerf360": 3},
    "renderer_baseline_percentage": {"custom": 7.0, "DTU": 7.0, "TNT": 7.0,
                                     "MobileBrick": 14.0, "MipNerf360": 7.0},
    "stereo_warm": {"custom": False, "DTU": True, "TNT": True,
                    "MobileBrick": True, "MipNerf360": False},
    "TSDF_scale": {"custom": 1.0, "DTU": 1.0, "TNT": 1.0, "MobileBrick": 0.1,
                   "MipNerf360": 1.0},
    "TSDF_use_mask": {"custom": False, "DTU": True, "TNT": False,
                      "MobileBrick": True, "MipNerf360": False},
    "TSDF_min_depth_baselines": {"custom": 4, "DTU": 4, "TNT": 2,
                                 "MobileBrick": 4, "MipNerf360": 4},
    "TSDF_max_depth_baselines": {"custom": 20, "DTU": 20, "TNT": 10,
                                 "MobileBrick": 20, "MipNerf360": 15},
    "TSDF_cleaning_threshold": {"custom": 100000, "DTU": 100000,
                                "TNT": 100000, "MobileBrick": 10000,
                                "MipNerf360": 100000},
    "skip_video_extraction": {"custom": False, "DTU": True, "TNT": True,
                              "MobileBrick": True, "MipNerf360": True},
    "skip_colmap": {"custom": False, "DTU": True, "TNT": True,
                    "MobileBrick": True, "MipNerf360": True},
}

DEFAULT_SCANS = {
    "DTU": [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122],
    "TNT": ["Barn", "Caterpillar", "Ignatius", "Truck"],
    "MobileBrick": ["aston", "audi", "beetles", "big_ben", "boat", "bridge",
                    "cabin", "camera", "castle", "colosseum", "convertible",
                    "ferrari", "jeep", "london_bus", "motorcycle", "porsche",
                    "satellite", "space_shuttle"],
    "MipNerf360": ["counter", "garden"],
}


@dataclasses.dataclass
class PipelineArgs:
    """All pipeline flags with dataset-resolved defaults."""

    dataset: str = "custom"
    # General
    colmap_name: str = "sculpture"
    dataset_name: str = "custom"
    experiment_folder_name: Optional[str] = None
    # Preprocessing
    downsample: int = 1
    # GS
    GS_iterations: int = 30000
    GS_save_test_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [7000, 30000])
    GS_white_background: bool = False
    # Device count for GS training: 1 = one card, the reference's
    # behaviour; any other value raises until multi-device training is
    # ported (ROADMAP A16).
    GS_devices: int = 1
    # Renderer
    renderer_baseline_absolute: Optional[float] = None
    renderer_baseline_percentage: float = 7.0
    renderer_scene_360: bool = True
    renderer_folder_name: Optional[str] = None
    renderer_save_json: bool = True
    renderer_sort_cameras: bool = False
    # Stereo
    stereo_model: str = "DLNR_Middlebury"
    stereo_occlusion_threshold: int = 3
    stereo_warm: bool = False
    stereo_shading_eps: float = 1e-4
    # TSDF
    TSDF_scale: float = 1.0
    TSDF_dilate: int = 1
    TSDF_valid: Optional[List[int]] = None
    TSDF_skip: Optional[List[int]] = None
    TSDF_use_occlusion_mask: bool = True
    TSDF_use_mask: bool = False
    TSDF_invert_mask: bool = False
    TSDF_erode_mask: bool = True
    TSDF_erosion_kernel_size: int = 10
    TSDF_closing_kernel_size: int = 10
    TSDF_voxel: int = 2
    TSDF_sdf_trunc: float = 0.04
    TSDF_min_depth_baselines: int = 4
    TSDF_max_depth_baselines: int = 20
    TSDF_cleaning_threshold: int = 100000
    # Running
    GS_port: int = 8080
    skip_video_extraction: bool = False
    skip_colmap: bool = False
    skip_GS: bool = False
    skip_rendering: bool = False
    skip_masking: bool = False
    skip_TSDF: bool = False
    # custom-dataset extras
    video_extension: str = "mp4"
    video_interval: int = 10
    masker_automask: bool = False
    masker_prompt: str = "main_object"
    masker_SAM2_local: bool = False
    scans: Optional[list] = None

    @staticmethod
    def for_dataset(dataset: str, **overrides) -> "PipelineArgs":
        if dataset not in DATASETS:
            raise ValueError(f"unknown dataset {dataset!r}")
        args = PipelineArgs(dataset=dataset)
        for key, table in DEFAULT_VALUES.items():
            setattr(args, key, table[dataset])
        if dataset in DEFAULT_SCANS:
            args.scans = list(DEFAULT_SCANS[dataset])
        for k, v in overrides.items():
            if not hasattr(args, k):
                raise AttributeError(f"unknown pipeline arg {k!r}")
            setattr(args, k, v)
        return args


def make_parser(dataset: str) -> argparse.ArgumentParser:
    """CLI parser with the reference's flag surface (argument_utils.py)."""
    d = PipelineArgs.for_dataset(dataset)
    p = argparse.ArgumentParser(description="gs2mesh_torch arguments.")

    def flag(name, default, **kw):
        p.add_argument(f"--{name}", default=default, **kw)

    def boolflag(name, default):
        p.add_argument(f"--{name}", action="store_true", default=default)
        p.add_argument(f"--no-{name}", action="store_false", dest=name)

    flag("colmap_name", d.colmap_name, type=str)
    flag("dataset_name", d.dataset_name, type=str)
    flag("experiment_folder_name", None, type=str)
    flag("downsample", d.downsample, type=int)
    flag("GS_iterations", d.GS_iterations, type=int)
    flag("GS_save_test_iterations", d.GS_save_test_iterations, type=int,
         nargs="+")
    p.add_argument("--GS_white_background", action="store_true")
    flag("GS_devices", d.GS_devices, type=int)
    flag("renderer_baseline_absolute", None, type=float)
    flag("renderer_baseline_percentage", d.renderer_baseline_percentage,
         type=float)
    boolflag("renderer_scene_360", True)
    flag("renderer_folder_name", None, type=str)
    boolflag("renderer_save_json", True)
    p.add_argument("--renderer_sort_cameras", action="store_true")
    flag("stereo_model", d.stereo_model, type=str)
    flag("stereo_occlusion_threshold", d.stereo_occlusion_threshold, type=int)
    boolflag("stereo_warm", d.stereo_warm)
    flag("stereo_shading_eps", d.stereo_shading_eps, type=float)
    flag("TSDF_scale", d.TSDF_scale, type=float)
    flag("TSDF_dilate", d.TSDF_dilate, type=int)
    flag("TSDF_valid", None, type=str)
    flag("TSDF_skip", None, type=str)
    boolflag("TSDF_use_occlusion_mask", True)
    boolflag("TSDF_use_mask", d.TSDF_use_mask)
    p.add_argument("--TSDF_invert_mask", action="store_true")
    boolflag("TSDF_erode_mask", True)
    flag("TSDF_erosion_kernel_size", d.TSDF_erosion_kernel_size, type=int)
    flag("TSDF_closing_kernel_size", d.TSDF_closing_kernel_size, type=int)
    flag("TSDF_voxel", d.TSDF_voxel, type=int)
    flag("TSDF_sdf_trunc", d.TSDF_sdf_trunc, type=float)
    flag("TSDF_min_depth_baselines", d.TSDF_min_depth_baselines, type=int)
    flag("TSDF_max_depth_baselines", d.TSDF_max_depth_baselines, type=int)
    flag("TSDF_cleaning_threshold", d.TSDF_cleaning_threshold, type=int)
    flag("GS_port", d.GS_port, type=int)
    for name in ("skip_video_extraction", "skip_colmap", "skip_GS",
                 "skip_rendering", "skip_masking", "skip_TSDF"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(d, name))
    if dataset == "custom":
        flag("video_extension", d.video_extension, type=str)
        flag("video_interval", d.video_interval, type=int)
        p.add_argument("--masker_automask", action="store_true")
        flag("masker_prompt", d.masker_prompt, type=str)
        p.add_argument("--masker_SAM2_local", action="store_true")
    if dataset in DEFAULT_SCANS:
        scan_type = int if dataset == "DTU" else str
        flag("scans", DEFAULT_SCANS[dataset], type=scan_type, nargs="+")
    return p

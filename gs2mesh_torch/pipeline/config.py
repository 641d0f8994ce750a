"""Pipeline flags read by the stereo-pair renderer, the stereo stage and the
TSDF stage, with the per-dataset default tables of the reference ArgParser
(gs2mesh_utils/argument_utils.py).

The port's copy of gs2mesh_tpu pipeline/config.py::PipelineArgs, cut to the
fields the ported stages read; later stages add theirs as they are ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

DATASETS = ("custom", "DTU", "TNT", "MobileBrick", "MipNerf360")

DEFAULT_VALUES = {
    "colmap_name": {"custom": "sculpture", "DTU": "scan24", "TNT": "Ignatius",
                    "MobileBrick": "aston", "MipNerf360": "garden"},
    "dataset_name": {"custom": "custom", "DTU": "DTU", "TNT": "TNT",
                     "MobileBrick": "MobileBrick", "MipNerf360": "MipNerf360"},
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
}


@dataclasses.dataclass
class PipelineArgs:
    dataset: str = "custom"
    colmap_name: str = "sculpture"
    dataset_name: str = "custom"
    GS_iterations: int = 30000
    GS_white_background: bool = False
    renderer_baseline_absolute: Optional[float] = None
    renderer_baseline_percentage: float = 7.0
    renderer_scene_360: bool = True
    renderer_save_json: bool = True
    renderer_sort_cameras: bool = False
    stereo_model: str = "DLNR_Middlebury"
    stereo_occlusion_threshold: int = 3
    stereo_warm: bool = False
    stereo_shading_eps: float = 1e-4
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

    @staticmethod
    def for_dataset(dataset: str, **overrides) -> "PipelineArgs":
        if dataset not in DATASETS:
            raise ValueError(f"unknown dataset {dataset!r}")
        args = PipelineArgs(dataset=dataset)
        for key, table in DEFAULT_VALUES.items():
            setattr(args, key, table[dataset])
        for k, v in overrides.items():
            if not hasattr(args, k):
                raise AttributeError(f"unknown pipeline arg {k!r}")
            setattr(args, k, v)
        return args

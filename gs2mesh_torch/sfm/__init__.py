"""SfM stage: frame extraction, image downsampling, and the COLMAP
subprocess driver (COLMAP stays an external binary, exactly as in the
reference — gs2mesh_utils/colmap_utils.py). The port's copy of
gs2mesh_tpu sfm/."""

from gs2mesh_torch.sfm.colmap_driver import (create_downsampled_colmap_dir,
                                           create_mobile_brick_colmap_files,
                                           extract_frames, run_colmap,
                                           run_colmap_known_poses)

__all__ = ["extract_frames", "create_downsampled_colmap_dir", "run_colmap",
           "run_colmap_known_poses", "create_mobile_brick_colmap_files"]

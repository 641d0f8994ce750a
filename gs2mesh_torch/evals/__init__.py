"""Dataset evaluation harnesses (DTU / Tanks&Temples / MobileBrick).

numpy/scipy re-implementations of the reference's evaluation/ tree
(evaluation/DTU/eval_code, evaluation/TNT/eval_code/python_toolbox,
evaluation/MobileBrick/eval_code) without the Open3D/sklearn
dependencies: same protocols, metrics, and output artifacts. The port's
copy of gs2mesh_tpu evals/.
"""

from gs2mesh_torch.evals.geometry import (icp_point_to_point, nn_distances,
                                          radius_downsample,
                                          sample_mesh_surface, umeyama,
                                          voxel_downsample)
from gs2mesh_torch.evals.dtu import cull_scan, dtu_eval
from gs2mesh_torch.evals.tnt import run_evaluation as tnt_run_evaluation
from gs2mesh_torch.evals.tnt import scenes_tau_dict
from gs2mesh_torch.evals.mobilebrick import \
    evaluate_single as mobilebrick_evaluate_single

__all__ = ["sample_mesh_surface", "radius_downsample", "voxel_downsample",
           "nn_distances", "umeyama", "icp_point_to_point", "cull_scan",
           "dtu_eval", "tnt_run_evaluation", "scenes_tau_dict",
           "mobilebrick_evaluate_single"]

"""Pipeline stage layer: the gs2mesh 7-stage batch pipeline
(video -> COLMAP -> GS training -> stereo-pair rendering -> DLNR depth ->
masking -> TSDF fusion -> mesh), staged through the same on-disk artifact
layout as the reference (output/<exp>/<scene>/NNN/{left,right}.png,
camera_data.json, NNN/out_<model>/ (disparities, occlusion mask, depth,
shading), NNN/left_mask.{npy,png} and <name>_{mesh,cleaned_mesh}.ply), so
its evaluators and tooling work unchanged. The port's copy of gs2mesh_tpu
pipeline/; ``run_single`` (pipeline/run_single.py) chains the stages.

Reference: gs2mesh_utils/{renderer_utils,stereo_utils,masker_utils,
tsdf_utils,argument_utils,eval_utils}.py and run_single.py.
"""

from gs2mesh_torch.pipeline.config import (PipelineArgs, encode_string,
                                           make_parser)
from gs2mesh_torch.pipeline.strings import (create_strings, prepare_eval,
                                            write_to_csv)
from gs2mesh_torch.pipeline.renderer_stage import Renderer
from gs2mesh_torch.pipeline.stereo_stage import Stereo
from gs2mesh_torch.pipeline.masker_stage import (CopyMasker, FullMasker, Masker,
                                                 SAM2Masker, init_predictor)
from gs2mesh_torch.pipeline.masker_ui import (InteractiveSeeder,
                                              run_interactive_masker)
from gs2mesh_torch.pipeline.tsdf_stage import TSDF

__all__ = ["PipelineArgs", "encode_string", "make_parser", "create_strings",
           "prepare_eval", "write_to_csv", "Renderer", "Stereo", "Masker",
           "TSDF", "FullMasker", "CopyMasker", "SAM2Masker",
           "init_predictor", "InteractiveSeeder", "run_interactive_masker"]

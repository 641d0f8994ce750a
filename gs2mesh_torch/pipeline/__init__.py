"""Pipeline stage layer (ported so far: the stereo-pair renderer, the stereo
stage, the masker contract and the TSDF stage), writing the reference's
on-disk layout: output/<exp>/<scene>/NNN/{left,right}.png, camera_data.json,
NNN/out_<model>/ (disparities, occlusion mask, depth, shading),
NNN/left_mask.{npy,png} and <name>_{mesh,cleaned_mesh}.ply."""

from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.masker_stage import CopyMasker, FullMasker
from gs2mesh_torch.pipeline.renderer_stage import Renderer
from gs2mesh_torch.pipeline.stereo_stage import Stereo
from gs2mesh_torch.pipeline.tsdf_stage import TSDF

__all__ = ["PipelineArgs", "Renderer", "Stereo", "TSDF", "FullMasker",
           "CopyMasker"]

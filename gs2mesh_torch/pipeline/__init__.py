"""Pipeline stage layer (ported so far: the stereo-pair renderer and the
stereo stage), writing the reference's on-disk layout:
output/<exp>/<scene>/NNN/{left,right}.png, camera_data.json and
NNN/out_<model>/ (disparities, occlusion mask, depth, shading)."""

from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.renderer_stage import Renderer
from gs2mesh_torch.pipeline.stereo_stage import Stereo

__all__ = ["PipelineArgs", "Renderer", "Stereo"]

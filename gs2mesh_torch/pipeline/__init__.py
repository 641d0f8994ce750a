"""Pipeline stage layer (ported so far: the stereo-pair renderer), writing the
reference's on-disk layout: output/<exp>/<scene>/NNN/{left,right}.png and
camera_data.json."""

from gs2mesh_torch.pipeline.config import PipelineArgs
from gs2mesh_torch.pipeline.renderer_stage import Renderer

__all__ = ["PipelineArgs", "Renderer"]

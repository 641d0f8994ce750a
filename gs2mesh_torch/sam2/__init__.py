"""SAM2 (Segment Anything 2) in PyTorch: video object segmentation for the
automatic masking stage, the port of gs2mesh_tpu.sam2.

Hiera trunk + FPN neck, prompt encoder, two-way mask decoder, streaming
memory attention and encoder, and the image / video predictors.
``convert.load_sam2_checkpoint`` loads the released
sam2_hiera_{tiny,small,base_plus,large}.pt files; ``params_from_numpy``
carries a JAX parameter tree across.
"""

from gs2mesh_torch.sam2.model import (SAM2, SAM2Config, init_sam2_,
                                      init_sam2_params)
from gs2mesh_torch.sam2.predictor import SAM2ImagePredictor, SAM2VideoPredictor
from gs2mesh_torch.sam2.convert import (convert_sam2_checkpoint,
                                        load_sam2_checkpoint, load_weights,
                                        params_from_numpy)

__all__ = ["SAM2", "SAM2Config", "init_sam2_", "init_sam2_params",
           "SAM2ImagePredictor", "SAM2VideoPredictor",
           "convert_sam2_checkpoint", "load_sam2_checkpoint", "load_weights",
           "params_from_numpy"]

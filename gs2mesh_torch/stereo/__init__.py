"""DLNR stereo matching ("High-Frequency Stereo Matching Network", CVPR'23)
in PyTorch: the port of gs2mesh_tpu.stereo.

Used for inference only, by the stereo stage; ``convert.load_checkpoint``
reads the released DLNR_Middlebury / DLNR_SceneFlow weights and
``convert.params_from_numpy`` carries a JAX parameter tree across.
"""

from gs2mesh_torch.stereo.convert import (load_checkpoint, load_weights,
                                          params_from_numpy)
from gs2mesh_torch.stereo.dlnr import DLNR, DLNRConfig, dlnr_forward, init_dlnr_
from gs2mesh_torch.stereo.padder import InputPadder

__all__ = ["DLNR", "DLNRConfig", "dlnr_forward", "init_dlnr_", "InputPadder",
           "load_checkpoint", "load_weights", "params_from_numpy"]

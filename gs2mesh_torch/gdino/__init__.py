"""GroundingDINO (the open-vocabulary detector of the masker's text prompt)
in PyTorch, the port of gs2mesh_tpu.gdino.

Swin-T backbone, BERT text encoder, the bidirectional vision-language
feature enhancer, multi-scale deformable attention encoder and decoder
(bilinear gathers), language-guided two-stage query selection, and
``predict``. ``convert.load_gdino_checkpoint`` loads the released
groundingdino_swint_ogc.pth; ``params_from_numpy`` carries a JAX parameter
tree across; ``tokenizer.load_tokenizer`` reads a bert-base-uncased
``vocab.txt``.
"""

from gs2mesh_torch.gdino.model import (GDINO, GDINOConfig, gdino_decode,
                                       gdino_encode, gdino_forward,
                                       init_gdino_, init_gdino_params,
                                       prepare_text_inputs)
from gs2mesh_torch.gdino.convert import (convert_gdino_checkpoint,
                                         load_gdino_checkpoint, load_weights,
                                         params_from_numpy,
                                         released_state_dict)
from gs2mesh_torch.gdino.inference import best_box_xyxy, predict
from gs2mesh_torch.gdino.tokenizer import BertTokenizer, load_tokenizer

__all__ = ["GDINO", "GDINOConfig", "gdino_encode", "gdino_decode",
           "gdino_forward", "init_gdino_",
           "init_gdino_params", "prepare_text_inputs",
           "convert_gdino_checkpoint", "load_gdino_checkpoint",
           "load_weights", "params_from_numpy", "released_state_dict",
           "predict", "best_box_xyxy", "BertTokenizer", "load_tokenizer"]

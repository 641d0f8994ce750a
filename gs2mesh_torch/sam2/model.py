"""SAM2 core model: image encoding, the SAM heads and memory conditioning.

The port of gs2mesh_tpu sam2/model.py (sam2/modeling/sam2_base.py, SAM2Base's
inference path with the released configs' flags: high-res SAM features,
object scores with a fixed no-object pointer, object pointers in the
encoder without a temporal encoding, the no-memory embedding added
directly). ``SAM2`` holds every weight under the released checkpoint's key;
the functions take it and channels-last (B, H, W, C) features. The host
state of the video predictor lives in predictor.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn

from gs2mesh_torch.sam2.hiera import (HieraConfig, ImageEncoder,
                                      fpn_neck_forward, hiera_forward)
from gs2mesh_torch.sam2.layers import (MLP, Norm, conv2d, mlp, resize_linear)
from gs2mesh_torch.sam2.memory import (MemoryAttention, MemoryEncoder,
                                       memory_attention, memory_encoder)
from gs2mesh_torch.sam2.sam_heads import (MaskDecoder, PromptEncoder,
                                          get_dense_pe, mask_decoder,
                                          prompt_encoder)

NO_OBJ_SCORE = -1024.0


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = HieraConfig()
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    image_size: int = 1024
    backbone_stride: int = 16
    hidden_dim: int = 256
    mem_dim: int = 64
    num_maskmem: int = 7
    max_obj_ptrs_in_encoder: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    memory_temporal_stride: int = 1

    @property
    def feat_size(self) -> int:
        return self.image_size // self.backbone_stride

    @staticmethod
    def tiny(image_size: int = 1024) -> "SAM2Config":
        return SAM2Config(hiera=HieraConfig(), image_size=image_size)

    @staticmethod
    def small(image_size: int = 1024) -> "SAM2Config":
        return SAM2Config(
            hiera=HieraConfig(stages=(1, 2, 11, 2),
                              global_att_blocks=(7, 10, 13)),
            image_size=image_size)

    @staticmethod
    def base_plus(image_size: int = 1024) -> "SAM2Config":
        return SAM2Config(
            hiera=HieraConfig(embed_dim=112, num_heads=2),
            backbone_channel_list=(896, 448, 224, 112),
            image_size=image_size)

    @staticmethod
    def large(image_size: int = 1024) -> "SAM2Config":
        return SAM2Config(
            hiera=HieraConfig(embed_dim=144, num_heads=2,
                              stages=(2, 6, 36, 4),
                              global_att_blocks=(23, 33, 43),
                              window_spec=(8, 4, 16, 8)),
            backbone_channel_list=(1152, 576, 288, 144),
            image_size=image_size)


class SAM2(nn.Module):
    """Every SAM2 weight, named as in the released ``{"model": ...}`` state
    dict (the tree gs2mesh_tpu sam2/model.py::init_sam2_params builds)."""

    def __init__(self, cfg: SAM2Config = SAM2Config.tiny()):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        self.image_encoder = ImageEncoder(cfg.hiera,
                                          list(cfg.backbone_channel_list))
        self.sam_prompt_encoder = PromptEncoder(C)
        self.sam_mask_decoder = MaskDecoder(C)
        self.memory_attention = MemoryAttention(C, cfg.mem_dim)
        self.memory_encoder = MemoryEncoder(C, cfg.mem_dim)
        self.obj_ptr_proj = MLP([C, C, C, C])
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)


# ---------------------------------------------------------------- forward

def forward_image(model: SAM2, img):
    """img: (B, H, W, 3) normalized. Returns {"backbone_fpn": NHWC features
    /4, /8, /16 (the /4 and /8 levels already projected by the decoder's
    conv_s0 / conv_s1, as sam2_base.forward_image does), "vision_pos_enc"}."""
    trunk_out = hiera_forward(img, model.image_encoder.trunk)
    feats, pos = fpn_neck_forward(trunk_out, model.image_encoder.neck)
    feats, pos = feats[:3], pos[:3]                     # scalp=1 drops /32
    dec = model.sam_mask_decoder
    feats[0] = conv2d(feats[0], dec.conv_s0)
    feats[1] = conv2d(feats[1], dec.conv_s1)
    return {"backbone_fpn": feats, "vision_pos_enc": pos}


def forward_sam_heads(model: SAM2, backbone_features, point_coords=None,
                      point_labels=None, mask_inputs=None,
                      high_res_features=None, multimask_output=False):
    """_forward_sam_heads (sam2_base.py:252-432), NHWC features.

    Returns (low_res_multimasks, high_res_multimasks, ious, low_res_masks,
    high_res_masks, obj_ptr, object_score_logits)."""
    cfg = model.cfg
    B = backbone_features.shape[0]
    es = cfg.feat_size
    ref = backbone_features
    if point_coords is None:
        point_coords = ref.new_zeros((B, 1, 2))
        point_labels = -torch.ones((B, 1), dtype=torch.int64,
                                   device=ref.device)

    sam_mask_prompt = None
    if mask_inputs is not None:
        sam_mask_prompt = mask_inputs.to(ref.dtype)
        if mask_inputs.shape[1] != 4 * es:
            sam_mask_prompt = resize_linear(
                sam_mask_prompt.permute(0, 3, 1, 2), 4 * es,
                4 * es).permute(0, 2, 3, 1)

    pe = model.sam_prompt_encoder
    sparse, dense = prompt_encoder(
        pe, (es, es), (cfg.image_size, cfg.image_size),
        points=(point_coords, point_labels), masks=sam_mask_prompt,
        batch_size=B)
    image_pe = get_dense_pe(pe, (es, es))

    masks, ious, sam_tokens, object_score_logits = mask_decoder(
        model.sam_mask_decoder, backbone_features, image_pe, sparse, dense,
        multimask_output, high_res_features)

    is_obj_appearing = object_score_logits > 0
    masks = torch.where(is_obj_appearing[:, :, None, None], masks,
                        NO_OBJ_SCORE)
    low_res_multimasks = masks
    high_res_multimasks = resize_linear(masks, cfg.image_size,
                                        cfg.image_size)

    sam_output_token = sam_tokens[:, 0]
    if multimask_output:
        best = torch.argmax(ious, dim=-1)
        bi = torch.arange(B, device=ref.device)
        low_res_masks = low_res_multimasks[bi, best][:, None]
        high_res_masks = high_res_multimasks[bi, best][:, None]
        if sam_tokens.shape[1] > 1:
            sam_output_token = sam_tokens[bi, best]
    else:
        low_res_masks, high_res_masks = (low_res_multimasks,
                                         high_res_multimasks)

    obj_ptr = mlp(sam_output_token, model.obj_ptr_proj)
    lam = is_obj_appearing.to(ref.dtype)
    obj_ptr = lam * obj_ptr + (1 - lam) * model.no_obj_ptr[0]
    return (low_res_multimasks, high_res_multimasks, ious, low_res_masks,
            high_res_masks, obj_ptr, object_score_logits)


def use_mask_as_output(model: SAM2, backbone_features, high_res_features,
                       mask_inputs):
    """_use_mask_as_output (sam2_base.py:434-461). mask_inputs: (B,
    image_size, image_size, 1) float or bool, NHWC."""
    out_scale, out_bias = 20.0, -10.0
    m = mask_inputs.to(backbone_features.dtype)
    high_res_masks = (m * out_scale + out_bias)[:, :, :, 0][:, None]
    low_res = resize_linear(high_res_masks, m.shape[1] // 4, m.shape[2] // 4)
    # The object pointer from the mask through the SAM decoder.
    mask_ds = conv2d(m, model.mask_downsample)
    obj_ptr = forward_sam_heads(model, backbone_features,
                                mask_inputs=mask_ds,
                                high_res_features=high_res_features)[5]
    lam = (m.reshape(m.shape[0], -1).amax(dim=1) > 0)[:, None].to(m.dtype)
    object_score_logits = out_scale * lam + out_bias
    obj_ptr = lam * obj_ptr + (1 - lam) * model.no_obj_ptr[0]
    return low_res, high_res_masks, obj_ptr, object_score_logits


def condition_features(model: SAM2, vision_feat, vision_pos, memories,
                       memory_pos, obj_ptrs):
    """_prepare_memory_conditioned_features for a non-initial frame
    (sam2_base.py:494-661). vision_feat / pos: (B, H, W, C); memories: (B,
    T, H', W', mem_dim) with their temporal embedding already added into
    memory_pos; obj_ptrs: (B, Np, C) (no temporal encoding: released
    configs set add_tpos_enc_to_obj_ptrs=False)."""
    cfg = model.cfg
    B, H, W, C = vision_feat.shape
    curr = vision_feat.reshape(B, H * W, C)
    curr_pos = vision_pos.reshape(B, H * W, C)
    mem = memories.reshape(B, -1, cfg.mem_dim)
    mem_pos = memory_pos.reshape(B, -1, cfg.mem_dim)
    num_obj_ptr_tokens = 0
    if obj_ptrs is not None and obj_ptrs.shape[1] > 0:
        split = C // cfg.mem_dim
        n = obj_ptrs.shape[1] * split
        mem = torch.cat([mem, obj_ptrs.reshape(B, n, cfg.mem_dim)], dim=1)
        mem_pos = torch.cat([mem_pos, mem_pos.new_zeros((B, n, cfg.mem_dim))],
                            dim=1)
        num_obj_ptr_tokens = n
    out = memory_attention(model.memory_attention, curr, curr_pos, mem,
                           mem_pos, num_obj_ptr_tokens, (H, W))
    return out.reshape(B, H, W, C)


def encode_new_memory(model: SAM2, vision_feat, high_res_masks):
    """_encode_new_memory (sam2_base.py:663-703). vision_feat (B, H, W, C);
    high_res_masks (B, 1, image, image) logits -> (features, pos)."""
    cfg = model.cfg
    m = torch.sigmoid(high_res_masks[:, 0])[..., None]
    m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
    return memory_encoder(model.memory_encoder, vision_feat, m)


# ------------------------------------------------------------------ params

@torch.no_grad()
def init_sam2_(model: SAM2, generator: torch.Generator) -> SAM2:
    """Seeded random weights with the JAX initialiser's shapes and scales
    (gs2mesh_tpu sam2/model.py:227-266), drawn from ``generator`` (not the
    same numbers): linear and conv weights N(0, 1/fan_in) (fan_in = in
    features x kernel area), zero biases, unit / zero norms, embeddings and
    the free embeddings N(0, 0.02^2), the random-PE matrix N(0, 1), the
    CXBlocks' gamma 1e-6."""
    def randn_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(mod, nn.Conv2d):
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            randn_(w, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Norm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            randn_(mod.weight, 0.02)
    trunk = model.image_encoder.trunk
    for p in (trunk.pos_embed, trunk.pos_embed_window, model.no_obj_ptr,
              model.maskmem_tpos_enc, model.no_mem_embed,
              model.no_mem_pos_enc):
        randn_(p, 0.02)
    randn_(model.sam_prompt_encoder.pe_layer
           .positional_encoding_gaussian_matrix, 1.0)
    for layer in model.memory_encoder.fuser.layers:
        layer.gamma.fill_(1e-6)
    return model


def init_sam2_params(cfg: SAM2Config = SAM2Config.tiny(), seed: int = 0):
    """A seeded random state dict of ``cfg``'s SAM2 in the released layout."""
    return init_sam2_(SAM2(cfg), torch.Generator().manual_seed(seed)
                      ).state_dict()

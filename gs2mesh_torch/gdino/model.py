"""GroundingDINO's top-level model, the port of gs2mesh_tpu gdino/model.py
(groundingdino/models/GroundingDINO/groundingdino.py in the SwinT-OGC
configuration: 4 feature levels, 6 + 6 layers, 900 queries, two-stage
"standard" query selection, one shared box head, text enhancer, fusion and
text cross-attention). The single-image inference path (B = 1, no padding
masks).

``GDINO`` holds every weight under the released checkpoint's key (the
shared box head once, as ``bbox_embed.0``); ``gdino_forward`` runs it on
channels-last images in the weights' dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.gdino.bert import (BertConfig, BertModel, bert_encoder,
                                      generate_masks_with_special_tokens)
from gs2mesh_torch.gdino.fusion import MHA, BiAttentionBlock
from gs2mesh_torch.gdino.swin import SwinConfig, SwinTransformer, swin_forward
from gs2mesh_torch.gdino.transformer import (Transformer, contrastive_embed,
                                             decoder_forward, encoder_forward,
                                             gen_encoder_output_proposals,
                                             inverse_sigmoid)
from gs2mesh_torch.sam2.layers import (MLP, Named, Norm, conv2d, layer_norm,
                                       linear, mlp)

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    swin: SwinConfig = SwinConfig()
    bert: BertConfig = BertConfig()
    hidden_dim: int = 256
    num_heads: int = 8
    num_queries: int = 900
    num_feature_levels: int = 4
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    max_text_len: int = 256
    pe_temperature: float = 20.0
    # [CLS], [SEP], '.', '?' for bert-base-uncased
    special_token_ids: Tuple[int, ...] = (101, 102, 1012, 1029)


class GDINO(nn.Module):
    """Every GroundingDINO weight, named as in the released ``{"model":
    ...}`` state dict (groundingdino_swint_ogc.pth) without its copies of
    the shared box head and the buffers the forward recomputes
    (``convert.load_weights`` says which keys those are)."""

    def __init__(self, cfg: GDINOConfig = GDINOConfig()):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        nlvl = cfg.num_feature_levels
        self.backbone = nn.ModuleList([SwinTransformer(cfg.swin)])
        self.bert = BertModel(cfg.bert)
        self.feat_map = nn.Linear(cfg.bert.hidden_size, C)
        chans = cfg.swin.num_channels + [cfg.swin.num_channels[-1]]
        self.input_proj = nn.ModuleList(
            Named(**{"0": (nn.Conv2d(chans[i], C, 1) if i < nlvl - 1 else
                           nn.Conv2d(chans[i], C, 3, 2, 1)),
                     "1": Norm(C)})
            for i in range(nlvl))
        self.bbox_embed = nn.ModuleList([MLP([C, C, C, 4])])
        self.transformer = Transformer(
            C, cfg.num_heads, nlvl, cfg.num_encoder_layers,
            cfg.num_decoder_layers, cfg.num_queries)


# ---------------------------------------------------------------- forward

def group_norm(x, m: Norm, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channels of NHWC ``x``."""
    y = F.group_norm(x.permute(0, 3, 1, 2), num_groups, m.weight, m.bias,
                     eps)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=16)
def _sine_hw(h, w, num_pos_feats, temperature, device, dtype):
    scale = 2 * math.pi
    y = torch.arange(1, h + 1, dtype=f32)[:, None] * torch.ones(1, w)
    x = torch.arange(1, w + 1, dtype=f32)[None, :] * torch.ones(h, 1)
    eps = 1e-6
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=f32)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)

    def sin_cos(p):
        return torch.stack([torch.sin(p[:, :, 0::2]),
                            torch.cos(p[:, :, 1::2])], dim=3).reshape(h, w, -1)

    pos = torch.cat([sin_cos(y[:, :, None] / dim_t),
                     sin_cos(x[:, :, None] / dim_t)], dim=-1)
    return pos.to(device, dtype)


def sine_pos_hw(h: int, w: int, like, num_pos_feats: int = 128,
                temperature: float = 20.0):
    """PositionEmbeddingSineHW, normalised, on an all-valid mask
    (backbone/position_encoding.py:78-131) -> (H, W, 2*num_pos_feats):
    made on the host in float32 and cached per grid, device and dtype (read
    it only)."""
    return _sine_hw(h, w, num_pos_feats, float(temperature), like.device,
                    like.dtype)


def select_top(scores, k: int):
    """The indices of the k largest scores along the last axis, ties lower
    index first (jax.lax.top_k's order; invalid proposals tie exactly)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def gdino_encode(model: GDINO, image, input_ids, position_ids,
                 text_self_masks, text_pad_mask):
    """The forward up to and with the two-stage query selection.

    image: (1, H, W, 3) normalised NHWC (H, W multiples of 32), in the
    weights' dtype; input_ids / position_ids: (1, nt); text_self_masks:
    (1, nt, nt) bool, True where allowed; text_pad_mask: (1, nt) bool, True
    where PADDING.

    Returns dict(``memory`` (1, S, C) the encoder's image tokens,
    ``memory_text`` (1, nt, C), ``enc_logits`` (1, S) each proposal's best
    text logit, ``enc_coords`` (1, S, 4) each proposal's box before the
    sigmoid, ``topk`` (1, nq) the chosen proposals, ``shapes`` the levels'
    (H, W), ``text_pad_mask``): what gdino_decode takes. Each stage runs in
    a ``gdino.<stage>`` record_function range."""
    from torch.profiler import record_function

    cfg = model.cfg
    C = cfg.hidden_dim
    tp = model.transformer
    with record_function("gdino.bert"):
        hidden = bert_encoder(model.bert, input_ids, text_self_masks,
                              position_ids)
        text = linear(hidden, model.feat_map)               # (1, nt, C)

    with record_function("gdino.backbone"):
        feats = swin_forward(image, model.backbone[0])      # /8 /16 /32
        # the extra /64 level comes from the last backbone feature
        srcs = [group_norm(conv2d(f, getattr(proj, "0")),
                           getattr(proj, "1"))
                for f, proj in zip(feats + feats[-1:], model.input_proj)]
        shapes = [tuple(s.shape[1:3]) for s in srcs]
        src_flat = torch.cat([s.reshape(1, -1, C) for s in srcs], dim=1)
        pos_flat = torch.cat(
            [sine_pos_hw(h, w, image, C // 2, cfg.pe_temperature).reshape(
                1, -1, C) + tp.level_embed[i][None, None]
             for i, (h, w) in enumerate(shapes)], dim=1)

    with record_function("gdino.encoder"):
        memory, memory_text = encoder_forward(
            src_flat, pos_flat, text, text_pad_mask, text_self_masks,
            position_ids, shapes, tp.encoder, cfg.num_heads)

    with record_function("gdino.query_selection"):
        out_mem, out_props = gen_encoder_output_proposals(memory, shapes)
        out_mem = layer_norm(linear(out_mem, tp.enc_output),
                             tp.enc_output_norm)
        enc_logits = contrastive_embed(out_mem, memory_text, text_pad_mask,
                                       cfg.max_text_len).amax(dim=-1)
        topk = select_top(enc_logits, cfg.num_queries)      # (1, nq)
        enc_coords = mlp(out_mem, tp.enc_out_bbox_embed) + out_props
    return {"memory": memory, "memory_text": memory_text,
            "enc_logits": enc_logits, "enc_coords": enc_coords,
            "topk": topk, "shapes": shapes, "text_pad_mask": text_pad_mask}


def gdino_decode(model: GDINO, enc: dict, topk):
    """The decoder and the heads from the proposals ``topk`` (1, nq) of
    ``enc`` (gdino_encode's output): dict(pred_logits (1, nq, max_text_len),
    pred_boxes (1, nq, 4)), in the ``gdino.decoder`` range."""
    from torch.profiler import record_function

    cfg = model.cfg
    tp = model.transformer
    memory_text, pad = enc["memory_text"], enc["text_pad_mask"]
    with record_function("gdino.decoder"):
        refpoints = torch.gather(
            enc["enc_coords"], 1, topk[..., None].expand(-1, -1, 4))
        tgt = tp.tgt_embed.weight[None].expand(1, cfg.num_queries,
                                               cfg.hidden_dim)
        bbox_embed = model.bbox_embed[0]
        hs, refs = decoder_forward(
            tgt, refpoints.detach(), enc["memory"], memory_text, pad,
            enc["shapes"], tp.decoder, bbox_embed, cfg.num_heads)
        # The heads (groundingdino.py:330-348): the last layer's normed
        # output with the reference box it was given.
        delta = mlp(hs[-1], bbox_embed)
        boxes = torch.sigmoid(delta + inverse_sigmoid(refs[-2]))
        logits = contrastive_embed(hs[-1], memory_text, pad,
                                   cfg.max_text_len)
    return {"pred_logits": logits, "pred_boxes": boxes}


def gdino_forward(model: GDINO, image, input_ids, position_ids,
                  text_self_masks, text_pad_mask):
    """gdino_encode then gdino_decode on its own selection: dict(pred_logits
    (1, nq, max_text_len), pred_boxes (1, nq, 4)) and the selection's
    ``memory``, ``enc_logits`` and ``topk``."""
    enc = gdino_encode(model, image, input_ids, position_ids,
                       text_self_masks, text_pad_mask)
    out = gdino_decode(model, enc, enc["topk"])
    out.update((k, enc[k]) for k in ("memory", "enc_logits", "topk"))
    return out


def prepare_text_inputs(input_ids: np.ndarray,
                        cfg: GDINOConfig = GDINOConfig(), device="cuda"):
    """Host-side text preparation (groundingdino.py:246-293): the
    sub-sentence self-attention masks and restarted position ids, cut at
    max_text_len. Returns (ids, position_ids, self_masks, pad_mask) on
    ``device``."""
    input_ids = np.asarray(input_ids)
    if input_ids.ndim == 1:
        input_ids = input_ids[None]
    self_masks, position_ids = generate_masks_with_special_tokens(
        input_ids, cfg.special_token_ids)
    n = min(input_ids.shape[1], cfg.max_text_len)
    pad_mask = np.zeros_like(input_ids[:, :n], bool)        # no padding, B=1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (input_ids[:, :n].astype(np.int64),
                           position_ids[:, :n], self_masks[:, :n, :n],
                           pad_mask))


# ------------------------------------------------------------------ params

@torch.no_grad()
def init_gdino_(model: GDINO, generator: torch.Generator) -> GDINO:
    """Seeded random weights with the JAX initialiser's shapes and scales
    (gs2mesh_tpu gdino/model.py:157-234), drawn from ``generator`` (not the
    same numbers): linear and conv weights N(0, 1/fan_in), zero biases,
    unit / zero norms, the attention tables and BERT's embeddings
    N(0, 0.02^2), the packed attention projections N(0, 1/C) with zero
    biases, the layer scales 1e-4, the level and query embeddings
    N(0, 1)."""
    def randn_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = mod.weight
            randn_(w, 1.0 / math.sqrt(w[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Norm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            randn_(mod.weight, 0.02)
        elif isinstance(mod, MHA):
            randn_(mod.in_proj_weight, 1.0 / math.sqrt(
                mod.in_proj_weight.shape[1]))
            mod.in_proj_bias.zero_()
        elif isinstance(mod, BiAttentionBlock):
            mod.gamma_v.fill_(1e-4)
            mod.gamma_l.fill_(1e-4)
    for layer in model.backbone[0].layers:
        for block in layer.blocks:
            randn_(block.attn.relative_position_bias_table, 0.02)
    randn_(model.transformer.level_embed, 1.0)
    randn_(model.transformer.tgt_embed.weight, 1.0)
    return model


def init_gdino_params(cfg: GDINOConfig = GDINOConfig(), seed: int = 0):
    """A seeded random state dict of ``cfg``'s GroundingDINO in the port's
    layout."""
    return init_gdino_(GDINO(cfg), torch.Generator().manual_seed(seed)
                       ).state_dict()

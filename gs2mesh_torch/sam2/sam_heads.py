"""SAM prompt encoder, two-way transformer and mask decoder, the port of
gs2mesh_tpu sam2/sam_heads.py (sam2/modeling/sam/{prompt_encoder,
transformer,mask_decoder}.py; the inference path with SAM2's object-score
head).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import (MLP, Attention, Norm, attention,
                                       conv2d, conv_transpose2d_s2,
                                       layer_norm, layer_norm_2d, mlp,
                                       random_pe_coords, random_pe_grid)


# ------------------------------------------------------------------ modules

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))


class PromptEncoder(nn.Module):
    def __init__(self, C: int = 256):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(C // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, C)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, C)
        self.no_mask_embed = nn.Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), Norm(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), Norm(16), nn.GELU(),
            nn.Conv2d(16, C, 1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, C: int, mlp_dim: int = 2048):
        super().__init__()
        self.self_attn = Attention(C, C)
        self.norm1 = Norm(C)
        self.cross_attn_token_to_image = Attention(C, C // 2)
        self.norm2 = Norm(C)
        self.mlp = MLP([C, mlp_dim, C])
        self.norm3 = Norm(C)
        self.norm4 = Norm(C)
        self.cross_attn_image_to_token = Attention(C, C // 2)


class TwoWayTransformer(nn.Module):
    def __init__(self, C: int, depth: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(C)
                                    for _ in range(depth))
        self.final_attn_token_to_image = Attention(C, C // 2)
        self.norm_final_attn = Norm(C)


class MaskDecoder(nn.Module):
    def __init__(self, C: int = 256, num_mask_tokens: int = 4):
        super().__init__()
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(num_mask_tokens, C)
        self.obj_score_token = nn.Embedding(1, C)
        self.transformer = TwoWayTransformer(C)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, 2), Norm(C // 4), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, 2), nn.GELU())
        self.conv_s0 = nn.Conv2d(C, C // 8, 1)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP([C, C, C, C // 8]) for _ in range(num_mask_tokens))
        self.iou_prediction_head = MLP([C, 256, 256, num_mask_tokens])
        self.pred_obj_score_head = MLP([C, C, C, 1])


# ------------------------------------------------------------ prompt encoder

def embed_points(m: PromptEncoder, points, labels, input_image_size,
                 pad: bool):
    """_embed_points (prompt_encoder.py:80-104). points: (B, N, 2) pixel
    coordinates; labels: (B, N) in {-1, 0, 1, 2, 3}."""
    points = points + 0.5
    if pad:
        b = points.shape[0]
        points = torch.cat([points, points.new_zeros((b, 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
    size = points.new_tensor([input_image_size[1], input_image_size[0]])
    pe = random_pe_coords(m.pe_layer.positional_encoding_gaussian_matrix,
                          points / size)
    lab = labels[..., None]
    out = torch.where(lab == -1, m.not_a_point_embed.weight[0], pe)
    for i in range(4):
        out = out + torch.where(lab == i, m.point_embeddings[i].weight[0],
                                0.0)
    return out


def embed_boxes(m: PromptEncoder, boxes, input_image_size):
    """_embed_boxes (prompt_encoder.py:106-114). boxes: (B, 4) xyxy."""
    size = boxes.new_tensor([input_image_size[1], input_image_size[0]])
    pe = random_pe_coords(m.pe_layer.positional_encoding_gaussian_matrix,
                          (boxes.reshape(-1, 2, 2) + 0.5) / size)
    corner = torch.stack([m.point_embeddings[2].weight[0],
                          m.point_embeddings[3].weight[0]])
    return pe + corner


def embed_masks(m: PromptEncoder, masks):
    """mask_downscaling (prompt_encoder.py:57-65) on NHWC masks."""
    s = m.mask_downscaling
    x = F.gelu(layer_norm_2d(conv2d(masks, s[0]), s[1]))
    x = F.gelu(layer_norm_2d(conv2d(x, s[3]), s[4]))
    return conv2d(x, s[6])


def prompt_encoder(m: PromptEncoder, image_embedding_size, input_image_size,
                   points=None, boxes=None, masks=None, batch_size=1):
    """Returns (sparse (B, N, C), dense (B, H, W, C))."""
    C = m.no_mask_embed.weight.shape[-1]
    ref = m.no_mask_embed.weight
    parts = []
    if points is not None:
        coords, labels = points
        parts.append(embed_points(m, coords, labels, input_image_size,
                                  pad=boxes is None))
    if boxes is not None:
        parts.append(embed_boxes(m, boxes, input_image_size))
    sparse = (torch.cat(parts, dim=1) if parts
              else ref.new_zeros((batch_size, 0, C)))
    if masks is not None:
        dense = embed_masks(m, masks)
    else:
        h, w = image_embedding_size
        dense = ref[0][None, None, None, :].expand(sparse.shape[0], h, w, C)
    return sparse, dense


def get_dense_pe(m: PromptEncoder, image_embedding_size):
    return random_pe_grid(m.pe_layer.positional_encoding_gaussian_matrix,
                          *image_embedding_size)                # (H, W, C)


# ------------------------------------------------------- two-way transformer

def twoway_block(m: TwoWayAttentionBlock, queries, keys, query_pe, key_pe,
                 num_heads: int, skip_first_layer_pe: bool):
    if skip_first_layer_pe:
        queries = attention(queries, queries, queries, m.self_attn, num_heads)
    else:
        q = queries + query_pe
        queries = queries + attention(q, q, queries, m.self_attn, num_heads)
    queries = layer_norm(queries, m.norm1)

    q, k = queries + query_pe, keys + key_pe
    queries = queries + attention(q, k, keys, m.cross_attn_token_to_image,
                                  num_heads)
    queries = layer_norm(queries, m.norm2)
    queries = layer_norm(queries + mlp(queries, m.mlp), m.norm3)

    q, k = queries + query_pe, keys + key_pe
    keys = keys + attention(k, q, queries, m.cross_attn_image_to_token,
                            num_heads)
    return queries, layer_norm(keys, m.norm4)


def twoway_transformer(m: TwoWayTransformer, image_embedding, image_pe,
                       point_embedding, num_heads: int = 8):
    """image_embedding / image_pe: (B, H, W, C); point_embedding (B, N, C).
    Returns (queries, keys (B, HW, C))."""
    b, h, w, c = image_embedding.shape
    keys = image_embedding.reshape(b, h * w, c)
    key_pe = image_pe.reshape(b, h * w, c) if image_pe.ndim == 4 else image_pe
    queries = point_embedding
    for i, layer in enumerate(m.layers):
        queries, keys = twoway_block(layer, queries, keys, point_embedding,
                                     key_pe, num_heads,
                                     skip_first_layer_pe=(i == 0))
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + attention(q, k, keys, m.final_attn_token_to_image,
                                  num_heads)
    return layer_norm(queries, m.norm_final_attn), keys


# ------------------------------------------------------------- mask decoder

def mask_decoder(m: MaskDecoder, image_embeddings, image_pe, sparse_prompt,
                 dense_prompt, multimask_output: bool, high_res_features,
                 pred_obj_scores: bool = True,
                 use_multimask_token_for_obj_ptr: bool = True):
    """MaskDecoder.forward / predict_masks (mask_decoder.py:115-245), NHWC.

    image_embeddings / dense_prompt: (B, H, W, C); image_pe: (H, W, C).
    Returns (masks (B, M, 4H, 4W), iou_pred (B, M), sam_tokens (B, ., C),
    object_score_logits (B, 1))."""
    num_mask_tokens = m.mask_tokens.weight.shape[0]
    b = sparse_prompt.shape[0]
    toks = [m.iou_token.weight, m.mask_tokens.weight]
    s = 0
    if pred_obj_scores:
        toks = [m.obj_score_token.weight] + toks
        s = 1
    output_tokens = torch.cat(toks, dim=0)
    output_tokens = output_tokens[None].expand((b,) + output_tokens.shape)
    tokens = torch.cat([output_tokens, sparse_prompt], dim=1)

    src = image_embeddings + dense_prompt
    pos_src = image_pe[None].expand(src.shape)
    hs, src_out = twoway_transformer(m.transformer, src, pos_src, tokens)
    iou_token_out = hs[:, s]
    mask_tokens_out = hs[:, s + 1: s + 1 + num_mask_tokens]

    B, H, W, C = src.shape
    src_img = src_out.reshape(B, H, W, C)
    # Output upscaling with the high-res skip features
    # (mask_decoder.py:218-226).
    feat_s0, feat_s1 = high_res_features
    up_m = m.output_upscaling
    up = conv_transpose2d_s2(src_img, up_m[0])
    up = F.gelu(layer_norm_2d(up + feat_s1, up_m[1]))
    up = F.gelu(conv_transpose2d_s2(up, up_m[3]) + feat_s0)   # (B, 4H, 4W, C/8)

    hyper = torch.stack([mlp(mask_tokens_out[:, i], head)
                         for i, head in
                         enumerate(m.output_hypernetworks_mlps)], dim=1)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, up)

    iou_pred = mlp(iou_token_out, m.iou_prediction_head, sigmoid_output=True)
    if pred_obj_scores:
        object_score_logits = mlp(hs[:, 0], m.pred_obj_score_head)
    else:
        object_score_logits = 10.0 * hs.new_ones((b, 1))

    if multimask_output:
        masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
        sam_tokens_out = (mask_tokens_out[:, 1:]
                          if use_multimask_token_for_obj_ptr
                          else mask_tokens_out[:, 0:1])
    else:
        masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
        sam_tokens_out = mask_tokens_out[:, 0:1]
    return masks, iou_pred, sam_tokens_out, object_score_logits

"""BERT text encoder (the HF bert-base layout) and GroundingDINO's text
masking, the port of gs2mesh_tpu gdino/bert.py (bertwarper.py's
BertModelWarper path): BERT embeddings and encoder driven by the
sub-sentence self-attention masks and the per-phrase position ids of
generate_masks_with_special_tokens (bertwarper.py:224-273). Module names
are the HF state dict's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.sam2.layers import Named, Norm, layer_norm, linear

MASK_NEG = -1e30
LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2


# ------------------------------------------------------------------ modules

class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.attention = Named(
            output=Named(dense=nn.Linear(C, C), LayerNorm=Norm(C)))
        # "self" cannot be a keyword of Named.
        self.attention.add_module("self", Named(
            query=nn.Linear(C, C), key=nn.Linear(C, C),
            value=nn.Linear(C, C)))
        self.intermediate = Named(dense=nn.Linear(C, I))
        self.output = Named(dense=nn.Linear(I, C), LayerNorm=Norm(C))


class BertModel(nn.Module):
    """BERT's embeddings and encoder (the pooler is not used)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.embeddings = Named(
            word_embeddings=nn.Embedding(cfg.vocab_size, C),
            position_embeddings=nn.Embedding(cfg.max_position_embeddings, C),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, C),
            LayerNorm=Norm(C))
        self.encoder = Named(layer=nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_layers)))


# ---------------------------------------------------------------- forward

def bert_embeddings(m, input_ids, position_ids, token_type_ids=None):
    x = m.word_embeddings.weight[input_ids]
    x = x + m.position_embeddings.weight[position_ids]
    tt = (token_type_ids if token_type_ids is not None
          else torch.zeros_like(input_ids))
    x = x + m.token_type_embeddings.weight[tt]
    return layer_norm(x, m.LayerNorm, eps=LN_EPS)


def _self_attention(x, m, num_heads: int, ext_mask):
    B, N, C = x.shape
    d = C // num_heads

    def heads(t):
        return t.reshape(B, N, num_heads, d).transpose(1, 2)

    q = heads(linear(x, m.self.query))
    k = heads(linear(x, m.self.key))
    v = heads(linear(x, m.self.value))
    attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    attn = torch.softmax(attn + ext_mask, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
    out = linear(out, m.output.dense)
    return layer_norm(x + out, m.output.LayerNorm, eps=LN_EPS)


def bert_layer(x, m: BertLayer, num_heads: int, ext_mask):
    x = _self_attention(x, m.attention, num_heads, ext_mask)
    h = F.gelu(linear(x, m.intermediate.dense))             # exact GELU
    h = linear(h, m.output.dense)
    return layer_norm(x + h, m.output.LayerNorm, eps=LN_EPS)


def bert_encoder(m: BertModel, input_ids, attention_mask_3d, position_ids):
    """attention_mask_3d: (B, N, N) bool, True where attention is allowed
    (the sub-sentence masks). Returns the last hidden state (B, N,
    hidden)."""
    x = bert_embeddings(m.embeddings, input_ids, position_ids)
    ext = torch.where(attention_mask_3d[:, None], 0.0, MASK_NEG).to(x.dtype)
    for layer in m.encoder.layer:
        x = bert_layer(x, layer, m.cfg.num_heads, ext)
    return x


def generate_masks_with_special_tokens(input_ids: np.ndarray,
                                       special_token_ids) -> tuple:
    """bertwarper.py:224-273 on the host: per-phrase block-diagonal
    self-attention masks and restarted position ids. input_ids: (B, N)
    numpy. Returns (attention_mask (B, N, N) bool, position_ids (B, N)
    int64)."""
    bs, num_token = input_ids.shape
    special = np.zeros((bs, num_token), bool)
    for tok in special_token_ids:
        special |= input_ids == tok

    attention_mask = np.tile(np.eye(num_token, dtype=bool), (bs, 1, 1))
    position_ids = np.zeros((bs, num_token), np.int64)
    idxs = np.argwhere(special)
    previous_col = 0
    for row, col in idxs:
        if col == 0 or col == num_token - 1:
            attention_mask[row, col, col] = True
            position_ids[row, col] = 0
        else:
            attention_mask[row, previous_col + 1: col + 1,
                           previous_col + 1: col + 1] = True
            position_ids[row, previous_col + 1: col + 1] = \
                np.arange(0, col - previous_col)
        previous_col = col
    return attention_mask, position_ids

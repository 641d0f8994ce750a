"""GroundingDINO weights in and out of the port.

The port's ``GDINO`` carries the released checkpoint's names, so a released
``groundingdino_swint_ogc.pth`` (``{"model": state_dict}``) loads with
``load_state_dict`` once ``load_weights`` has dropped the keys the forward
does not read (``SKIPPED``):

  * ``*.relative_position_index``: Swin's buffers, recomputed
    (``swin._rel_pos_index``);
  * ``bert.pooler.*``: BERT's pooler, which GroundingDINO does not run;
  * ``bert.embeddings.position_ids`` / ``token_type_ids``: HF BERT's
    buffers (the position ids come from the text masks);
  * ``bbox_embed.{1..5}.*`` and ``transformer.decoder.bbox_embed.*``: the
    copies and the decoder's alias of the one shared box head, held equal
    to ``bbox_embed.0`` (a difference raises).

Any other key the model lacks, and any weight the state dict lacks, raises.
``params_from_numpy`` carries a JAX parameter tree (gs2mesh_tpu
gdino/convert.py's layout) the other way, undoing its renames:
``backbone.`` -> ``backbone.0.``, ``mlp_seq.layers.{0,1}`` -> ``mlp.fc1`` /
``mlp.fc2``, ``bbox_embed.`` -> ``bbox_embed.0.``, conv weights HWIO ->
(O, I, kh, kw), linear ``w`` (I, O) -> weight (O, I) (``reduction`` has no
bias).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from gs2mesh_torch.gdino.model import GDINO, GDINOConfig
from gs2mesh_torch.gdino.swin import _rel_pos_index

SKIPPED = ("relative_position_index", "bert.pooler.",
           "bert.embeddings.position_ids", "bert.embeddings.token_type_ids")
_HEAD_COPY = re.compile(r"^(?:transformer\.decoder\.)?bbox_embed\.(\d+)\.")


def _rename(key: str) -> str:
    if key.startswith("backbone."):
        key = "backbone.0." + key[len("backbone."):]
    key = key.replace(".mlp_seq.layers.0.", ".mlp.fc1.")
    key = key.replace(".mlp_seq.layers.1.", ".mlp.fc2.")
    if key.startswith("bbox_embed."):
        key = "bbox_embed.0." + key[len("bbox_embed."):]
    return key


def params_from_numpy(tree: Mapping) -> dict:
    """JAX GroundingDINO parameter tree (leaves numpy arrays, or anything
    ``np.asarray`` takes) -> the port's state dict."""
    out = {}

    def walk(node, prefix):
        if "w" in node and not isinstance(node["w"], Mapping):
            w = np.asarray(node["w"])
            w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
            out[_rename(prefix + ".weight")] = torch.from_numpy(w.copy())
            if node.get("b") is not None:
                out[_rename(prefix + ".bias")] = torch.from_numpy(
                    np.array(node["b"]))
            return
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            elif v is not None:
                out[_rename(key)] = torch.from_numpy(np.array(v))

    walk(tree, "")
    return out


def strip_module_prefix(state: Mapping) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_weights(model: GDINO, state: Mapping) -> GDINO:
    """Copy a released-layout (or the port's own) state dict into
    ``model``: ``module.`` stripped, ``SKIPPED`` keys dropped, the shared
    box head's copies checked against ``bbox_embed.0``; a missing or an
    unexpected key raises."""
    state = strip_module_prefix(state)
    kept = {}
    copies = []
    for k, v in state.items():
        if any(s in k for s in SKIPPED):
            continue
        head = _HEAD_COPY.match(k)
        if head and (k.startswith("transformer.") or head.group(1) != "0"):
            copies.append((k, "bbox_embed.0." + k[head.end():], v))
            continue
        kept[k] = v
    for k, k0, v in copies:
        if k0 not in kept or not torch.equal(torch.as_tensor(v),
                                             torch.as_tensor(kept[k0])):
            raise ValueError(f"{k} is not a copy of the shared box head "
                             f"{k0}")
    model.load_state_dict(kept, strict=True)
    return model


def released_state_dict(state: Mapping, cfg: GDINOConfig = GDINOConfig(),
                        prefix: str = "") -> dict:
    """The port's state dict in the released checkpoint's layout: the shared
    box head under ``bbox_embed.{0..L-1}`` and the decoder's alias
    ``transformer.decoder.bbox_embed.{0..L-1}`` (L decoder layers), Swin's
    ``relative_position_index`` buffers and a zero BERT pooler, every key
    under ``prefix`` (the released file's is ``module.``)."""
    out = {}
    H = cfg.bert.hidden_size
    head = {k[len("bbox_embed.0."):]: v for k, v in state.items()
            if k.startswith("bbox_embed.0.")}
    idx = torch.from_numpy(_rel_pos_index(cfg.swin.window_size))
    for k, v in state.items():
        if k.startswith("bbox_embed."):
            continue
        out[k] = v
        if k.endswith(".attn.relative_position_bias_table"):
            out[k[:-len("relative_position_bias_table")]
                + "relative_position_index"] = idx.clone()
    for i in range(cfg.num_decoder_layers):
        for k, v in head.items():
            out[f"bbox_embed.{i}.{k}"] = v
            out[f"transformer.decoder.bbox_embed.{i}.{k}"] = v
    out["bert.pooler.dense.weight"] = torch.zeros(H, H)
    out["bert.pooler.dense.bias"] = torch.zeros(H)
    return {prefix + k: v for k, v in out.items()}


def convert_gdino_checkpoint(path: str) -> dict:
    """A released checkpoint file ({"model": state_dict}, or a bare state
    dict) -> its state dict on the CPU, without the ``module.`` prefix."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(blob["model"] if "model" in blob else blob)


def load_gdino_checkpoint(path: str,
                          cfg: GDINOConfig = GDINOConfig()) -> GDINO:
    """A released checkpoint file -> a ``cfg`` GroundingDINO on the CPU."""
    return load_weights(GDINO(cfg), convert_gdino_checkpoint(path))

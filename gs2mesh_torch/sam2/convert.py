"""SAM2 weights in and out of the port.

The port's modules carry the released checkpoints' names, so a released
``sam2_hiera_*.pt`` (``{"model": state_dict}``) loads with
``load_state_dict`` once the optional ``model.`` prefix is stripped
(``load_sam2_checkpoint``). ``params_from_numpy`` carries a JAX parameter
tree (gs2mesh_tpu sam2/convert.py's layout) the other way, undoing its
rules:

  * conv weight HWIO (kh, kw, I, O)          -> (O, I, kh, kw)
  * the two transposed convs (mask decoder output_upscaling.0 / .3),
    stored spatially flipped and IO-swapped   -> un-flipped (I, O, kh, kw)
  * linear ``w`` (I, O) + ``b``              -> weight (O, I) + bias
  * norms, embeddings, buffers and free parameters -> as they are
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gs2mesh_torch.sam2.model import SAM2, SAM2Config

_TRANSPOSE_CONV_PREFIXES = (
    "sam_mask_decoder.output_upscaling.0",
    "sam_mask_decoder.output_upscaling.3",
)


def params_from_numpy(tree: Mapping) -> dict:
    """JAX SAM2 parameter tree (leaves numpy arrays, or anything
    ``np.asarray`` takes) -> the port's state dict."""
    out = {}

    def walk(node, prefix):
        if "w" in node and not isinstance(node["w"], Mapping):
            w = np.asarray(node["w"])
            if w.ndim == 4 and prefix in _TRANSPOSE_CONV_PREFIXES:
                w = w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            else:
                w = w.T
            out[prefix + ".weight"] = torch.from_numpy(w.copy())
            if node.get("b") is not None:
                out[prefix + ".bias"] = torch.from_numpy(np.array(node["b"]))
            return
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v))

    walk(tree, "")
    return out


def strip_model_prefix(state: Mapping) -> dict:
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in state.items()}


def load_weights(model: SAM2, state: Mapping) -> SAM2:
    """Copy ``state`` into ``model``. Every weight of the model must be
    there; keys the port does not use (parts of SAM2Base the released
    inference path never runs) are ignored, as the JAX package's converter
    ignores them."""
    missing, _ = model.load_state_dict(strip_model_prefix(state),
                                       strict=False)
    if missing:
        raise KeyError(f"SAM2 state dict lacks {missing[:8]} "
                       f"({len(missing)} keys)")
    return model


def convert_sam2_checkpoint(path: str) -> dict:
    """A released checkpoint file ({"model": state_dict}, or a bare state
    dict) -> its state dict on the CPU, without the ``model.`` prefix."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return strip_model_prefix(blob["model"] if "model" in blob else blob)


def load_sam2_checkpoint(path: str, cfg: SAM2Config) -> SAM2:
    """A released checkpoint file -> a ``cfg`` SAM2 on the CPU."""
    return load_weights(SAM2(cfg), convert_sam2_checkpoint(path))

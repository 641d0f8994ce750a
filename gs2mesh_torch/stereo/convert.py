"""DLNR weights in and out of the port.

The port's modules carry the reference's state-dict names, so a released
DLNR checkpoint (DLNR_Middlebury / DLNR_SceneFlow, stereo_utils.py:56-58)
loads with ``load_state_dict``. ``params_from_numpy`` carries a JAX parameter
tree (gs2mesh_tpu stereo/convert.py's layout) the other way, undoing its
layout rules:

  * conv weight HWIO (kh, kw, I, O)        -> (O, I, kh, kw)
  * transpose-conv weight, stored spatially flipped and IO-swapped in
    HWIO                                    -> un-flipped (I, O, kh, kw)
  * ``b: None``                            -> no bias key
  * batch norm, layer norm, temperature     -> as they are
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# ConvTranspose2d weights (Conv2x(deconv=True).conv1, nets/feature.py:340-355).
_TRANSPOSE_CONV_PREFIXES = tuple(
    f"normalizationRefinement.deconv{i}{s}.conv1.conv"
    for i in range(1, 5) for s in ("a", "b"))


def params_from_numpy(tree: Mapping) -> dict:
    """JAX DLNR parameter tree (leaves numpy arrays, or anything
    ``np.asarray`` takes) -> the port's state dict (no num_batches_tracked)."""
    out = {}

    def walk(node, prefix):
        if "w" in node and not isinstance(node["w"], Mapping):
            w = np.asarray(node["w"])
            if prefix in _TRANSPOSE_CONV_PREFIXES:
                w = w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                w = w.transpose(3, 2, 0, 1)
            out[prefix + ".weight"] = torch.from_numpy(w.copy())
            if node.get("b") is not None:
                out[prefix + ".bias"] = torch.from_numpy(
                    np.array(node["b"]))
            return
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v))

    walk(tree, "")
    return out


def load_checkpoint(path: str) -> dict:
    """A torch DLNR checkpoint file -> its state dict on the CPU, without
    DataParallel's ``module.`` prefix and without ``num_batches_tracked``
    (unused in eval mode), as gs2mesh_tpu stereo/convert.py:39-46 reads
    it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state and isinstance(state["state_dict"], Mapping):
        state = state["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def load_weights(model: torch.nn.Module, state: Mapping) -> torch.nn.Module:
    """Copy a cleaned state dict into ``model``; every key must match but
    the batch norms' num_batches_tracked counters, which eval never reads."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"DLNR state dict: missing {missing}, unexpected "
                       f"{unexpected}")
    return model

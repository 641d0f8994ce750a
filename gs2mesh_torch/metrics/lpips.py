"""LPIPS perceptual metric, the port of gs2mesh_tpu metrics/lpips.py.

The reference's vendored ``lpipsPyTorch`` (third_party/gaussian-splatting/
lpipsPyTorch/modules/lpips.py, used by metrics.py): a VGG16 feature trunk,
per-tap unit-normalised feature differences, 1x1 linear heads, the spatial
mean, summed over the taps. ``LPIPS`` holds the trunk under torchvision's
``features.{N}`` names and the heads as ``lins.{i}``; its weights come from
a torchvision VGG16 state dict plus the LPIPS v0.1 heads
(``convert_lpips_checkpoint``) or from the seeded ``init_lpips_params``.
Images are (B, 3, H, W) in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from gs2mesh_torch import resolve_device
from gs2mesh_torch.core.precision import precision_scope

# VGG16 "features" plan (out channels, or "M" for a 2x2 max-pool) up to
# relu5_3; LPIPS taps the ReLU of conv 1, 3, 6, 9 and 12 (relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3).
_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512]
_TAPS = {1, 3, 6, 9, 12}
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _features():
    """torchvision's vgg16().features up to relu5_3 (indices 0-29)."""
    layers, cin = [], 3
    for spec in _VGG16_PLAN:
        if spec == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, spec, 3, padding=1), nn.ReLU()]
            cin = spec
    return nn.Sequential(*layers)


def _conv_indices():
    return [i for i, m in enumerate(_features()) if isinstance(m, nn.Conv2d)]


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = _features()
        convs = [m for m in self.features if isinstance(m, nn.Conv2d)]
        self.lins = nn.ParameterList(
            nn.Parameter(torch.zeros(convs[i].out_channels))
            for i in sorted(_TAPS))


def init_lpips_params(seed: int = 0) -> dict:
    """Seeded random weights as an ``LPIPS`` state dict, the same numbers as
    the JAX package's numpy initialiser (conv weights, biases and heads
    drawn in its order from ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    state, cin, ci, tap_ch = {}, 3, 0, []
    for idx, spec in zip(_conv_indices(), [s for s in _VGG16_PLAN
                                           if s != "M"]):
        w = rng.normal(0, 0.05, (3, 3, cin, spec)).astype(np.float32)
        b = rng.normal(0, 0.05, (spec,)).astype(np.float32)
        state[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"features.{idx}.bias"] = torch.from_numpy(b)
        if ci in _TAPS:
            tap_ch.append(spec)
        cin, ci = spec, ci + 1
    for i, ch in enumerate(tap_ch):
        state[f"lins.{i}"] = torch.from_numpy(
            np.abs(rng.normal(0, 0.05, (ch,))).astype(np.float32))
    return state


def lpips(net: LPIPS, img_a: torch.Tensor, img_b: torch.Tensor):
    """(B,) LPIPS distances of (B, 3, H, W) images in [0, 1]
    (lpipsPyTorch modules/lpips.py). The z-score applies to the input as
    given, with no [-1, 1] rescale, as the vendored reference does
    (metrics.py passes [0, 1] images straight through)."""
    p = net.features[0].weight
    shift = torch.from_numpy(_SHIFT).to(p)[None, :, None, None]
    scale = torch.from_numpy(_SCALE).to(p)[None, :, None, None]

    def taps(img):
        x = (img.to(p.dtype) - shift) / scale
        out, ci = [], 0
        for m in net.features:
            x = m(x)
            if isinstance(m, nn.ReLU):
                if ci in _TAPS:
                    out.append(x)
                ci += 1
        return out

    with precision_scope():
        total = 0.0
        for a, b, lin in zip(taps(img_a), taps(img_b), net.lins):
            # normalize_activation (utils.py): x / (||x||_2 + eps), channels.
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                     + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
                     + 1e-10)
            d = (a - b) ** 2
            total = total + torch.mean(torch.sum(d * lin[None, :, None, None],
                                                 dim=1), dim=(1, 2))
    return total


def convert_lpips_checkpoint(vgg_path: str, lin_path: str) -> dict:
    """A torchvision VGG16 state dict file (``features.{N}.weight``) and
    the LPIPS heads file -> an ``LPIPS`` state dict. Either file may be a
    torch file or an .npz with the same keys. Convs are taken in the order
    of their index, the heads in the sorted order of their ``.weight`` keys
    (as the JAX package sorts them)."""
    def load(path):
        if path.endswith(".npz"):
            return {k: torch.from_numpy(v) for k, v in np.load(path).items()}
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return blob.get("state_dict", blob)

    vgg, lin = load(vgg_path), load(lin_path)
    conv_keys = sorted((k for k in vgg
                        if k.endswith(".weight") and vgg[k].ndim == 4),
                       key=lambda k: int(k.split(".")[-2]))
    state = {}
    for idx, wk in zip(_conv_indices(), conv_keys):
        state[f"features.{idx}.weight"] = vgg[wk].float()
        state[f"features.{idx}.bias"] = vgg[wk[:-len("weight")] + "bias"
                                            ].float()
    lin_keys = sorted(k for k in lin if k.endswith(".weight"))
    if len(lin_keys) != len(_TAPS):
        raise KeyError(f"{lin_path}: {len(lin_keys)} LPIPS heads "
                       f"{lin_keys}, expected {len(_TAPS)}")
    for i, k in enumerate(lin_keys):
        state[f"lins.{i}"] = lin[k].reshape(-1).float()
    return state


def load_lpips(state: dict, device="cuda") -> LPIPS:
    """An ``LPIPS`` holding ``state``, on ``device``."""
    net = LPIPS()
    net.load_state_dict(state)
    return net.to(resolve_device(device)).eval().requires_grad_(False)

"""gs2mesh in PyTorch + CUDA for NVIDIA Hopper.

A port of ``gs2mesh_tpu`` (the JAX reference, kept beside it): same module
layout (``core/``, ``models/``, ``ops/rasterizer/``, ``pipeline/``), same
on-disk artifacts, same rasterizer semantics (the reference's exact-carry
mode). Entry points run on ``cuda`` unless the caller asks for ``cpu``;
which implementation runs follows the tensors' device: CUDA tensors launch
the hand-written kernels in ``csrc/``, CPU tensors take the plain PyTorch
versions beside them.
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if CUDA is asked for but absent
    (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return device

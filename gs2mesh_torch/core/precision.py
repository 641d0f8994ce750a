"""The float32 precision scope the port's nets run in."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision_scope():
    """Float32 convolutions and matrix products in full float32: TF32 off
    for cuDNN and cuBLAS inside the block, the caller's flags restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev

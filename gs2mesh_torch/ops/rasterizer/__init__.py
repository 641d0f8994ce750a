from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.api import rasterize, RasterizeOutput


def kernel_wrappers():
    """K1-K4's CUDA wrappers by name. Each adds one to its ``launches``
    where it launches its kernel, and nowhere else."""
    from gs2mesh_torch.ops.rasterizer.composite import (
        composite_backward_cuda, composite_cuda)
    from gs2mesh_torch.ops.rasterizer.emit import (emission_cuda,
                                                   segment_sum_cuda)

    return {"K1": emission_cuda, "K2": composite_cuda,
            "K3": composite_backward_cuda, "K4": segment_sum_cuda}


def preprocess_kernel_wrappers():
    """P1 and P2's CUDA wrappers (the preprocess and its backward) by
    name, counted as ``kernel_wrappers`` counts K1-K4."""
    from gs2mesh_torch.ops.rasterizer.preprocess import (
        preprocess_backward_cuda, preprocess_forward_cuda)

    return {"P1": preprocess_forward_cuda, "P2": preprocess_backward_cuda}

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

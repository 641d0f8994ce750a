"""Image-quality metrics: PSNR and SSIM live in ops.ssim, LPIPS here (the
port of gs2mesh_tpu.metrics)."""

from gs2mesh_torch.metrics.lpips import (LPIPS, convert_lpips_checkpoint,
                                         init_lpips_params, load_lpips, lpips)

__all__ = ["LPIPS", "lpips", "init_lpips_params", "convert_lpips_checkpoint",
           "load_lpips"]

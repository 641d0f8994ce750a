from gs2mesh_torch.ops.rasterizer.config import RasterizerConfig
from gs2mesh_torch.ops.rasterizer.api import rasterize, RasterizeOutput

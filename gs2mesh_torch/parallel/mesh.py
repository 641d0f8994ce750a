"""Device mesh + row-ownership helpers (port of gs2mesh_tpu parallel/mesh.py).

The workload's scaling axes (SURVEY.md §2f):
  * ``data``  — stereo views / training cameras (pure data parallelism;
    gradient all-reduce),
  * ``gauss`` — Gaussian primitives (each rank preprocesses its own rows;
    all-gather of the compact splat features before emission, an
    all-reduce of their gradient on the way back) and, on the same ranks,
    strided tile rows of the framebuffer.

The JAX package drives every device from one SPMD process; the port runs
one process per rank (``torchrun``, or any launcher that initialises
``torch.distributed``), and the mesh is a ``torch.distributed`` DeviceMesh
over the initialised world: rank r sits at (data r // gauss, gauss r %
gauss), so a ``gauss`` group is a run of consecutive ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gs2mesh_torch.core.camera import Camera

MESH_DIMS = ("data", "gauss")


def make_mesh(data: int = 1, gauss: int = 1, device_type: str = "cuda"):
    """(data, gauss) DeviceMesh over the initialised process group, whose
    world size must be data * gauss."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh({data}, {gauss}) needs an initialised process group "
            f"of {data * gauss} ranks (launch with torchrun --nproc-per-node "
            f"{data * gauss}, or call torch.distributed.init_process_group)")
    if dist.get_world_size() != data * gauss:
        raise ValueError(f"need {data * gauss} ranks, have "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (data, gauss),
                            mesh_dim_names=MESH_DIMS)


def mesh_coords(mesh) -> tuple:
    """(data index, gauss index) of this rank."""
    return mesh.get_local_rank("data"), mesh.get_local_rank("gauss")


def owned_rows(capacity: int, gauss: int, index: int) -> slice:
    """Rows of a capacity-row array that rank ``index`` of the gauss axis
    owns (the JAX package's param_spec, P("gauss") on the row axis)."""
    if capacity % gauss:
        raise ValueError(f"capacity {capacity} is not a multiple of the "
                         f"gauss axis {gauss}")
    n = capacity // gauss
    return slice(index * n, (index + 1) * n)


def batch_cameras(cameras) -> Camera:
    """Stack a list of Cameras into one Camera with a leading view axis on
    the tensor fields (width / height stay scalars)."""
    c0 = cameras[0]
    return Camera(
        world_view=torch.stack([c.world_view for c in cameras]),
        full_proj=torch.stack([c.full_proj for c in cameras]),
        cam_center=torch.stack([c.cam_center for c in cameras]),
        tan_fovx=torch.stack([c.tan_fovx for c in cameras]),
        tan_fovy=torch.stack([c.tan_fovy for c in cameras]),
        width=c0.width, height=c0.height)


def index_camera(batched: Camera, i: int) -> Camera:
    return Camera(world_view=batched.world_view[i],
                  full_proj=batched.full_proj[i],
                  cam_center=batched.cam_center[i],
                  tan_fovx=batched.tan_fovx[i],
                  tan_fovy=batched.tan_fovy[i],
                  width=batched.width, height=batched.height)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) rows of every rank of ``group`` -> (G * n, ...) in group
    rank order (no gradient)."""
    G = dist.get_world_size(group)
    if G == 1:
        return x
    out = x.new_empty((G * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out

"""Multi-node scaffolding: process-group init from the launcher's
environment + (node, local) hybrid meshes (port of gs2mesh_tpu
parallel/multihost.py).

Scaling past one node means a data-parallel axis across nodes with the
model ("gauss" / tile-row) axis kept inside each node's NVLink domain:

  * ``initialize()`` — ``torch.distributed.init_process_group`` from
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (NCCL on the
    card, gloo on the CPU); LOCAL_RANK picks this process's card. A no-op
    in a plain single process, and when already initialised.
  * ``make_hybrid_mesh(dcn_data, data, gauss)`` — a (dcn_data * data,
    gauss) mesh whose ``gauss`` groups stay within one node's local ranks
    (only the data-parallel all-reduce crosses nodes).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gs2mesh_torch.parallel.mesh import MESH_DIMS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialise the default process group (idempotent, env-aware).

    Arguments override the environment: coordinator_address "host:port"
    (MASTER_ADDR:MASTER_PORT), num_processes (WORLD_SIZE), process_id
    (RANK). Without a coordinator (no argument, no MASTER_ADDR) this does
    nothing."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_hybrid_mesh(dcn_data: int, data: int = 1, gauss: int = 1,
                     device_type: str = "cuda"):
    """(dcn_data * data, gauss) DeviceMesh with the node axis outermost.

    Rank r sits at row r // gauss of the flat ``data`` axis, whose outer
    stride walks nodes; each ``gauss`` group is a run of consecutive ranks,
    so it stays on one node when the node's local world (torchrun's
    LOCAL_WORLD_SIZE) is a multiple of ``gauss``. Every process must call
    it alike."""
    from torch.distributed.device_mesh import init_device_mesh

    need = dcn_data * data * gauss
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"need {need} ranks, have {world}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if local % gauss:
        raise ValueError(f"the gauss axis ({gauss}) must stay within a "
                         f"node's {local} local ranks")
    return init_device_mesh(device_type, (dcn_data * data, gauss),
                            mesh_dim_names=MESH_DIMS)


def process_local_batch(global_batch: int) -> int:
    """Per-process share of a data batch (equal split across processes)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} "
                         f"processes")
    return global_batch // n

"""Multi-rank training and inference over torch.distributed (port of
gs2mesh_tpu parallel/): one process per rank on a (data, gauss) mesh."""

from gs2mesh_torch.parallel.inference import (gather_volume,
                                              make_sharded_dlnr,
                                              make_sharded_integrate,
                                              shard_volume)
from gs2mesh_torch.parallel.mesh import (batch_cameras, index_camera,
                                         make_mesh, owned_rows)
from gs2mesh_torch.parallel.sharded_train import (ShardedTrainer,
                                                  rasterize_sharded,
                                                  sharded_gs_loss,
                                                  sharded_train_step)

__all__ = ["make_mesh", "batch_cameras", "index_camera", "owned_rows",
           "ShardedTrainer", "sharded_train_step", "rasterize_sharded",
           "sharded_gs_loss", "make_sharded_dlnr", "make_sharded_integrate",
           "shard_volume", "gather_volume"]

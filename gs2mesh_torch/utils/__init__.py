"""Shared utilities: profiling, stage timing, logging, debug dumps (the
port of gs2mesh_tpu utils/)."""

from gs2mesh_torch.utils.debug import (check_finite_tree, debug_dump,
                                       guard_render)
from gs2mesh_torch.utils.profiling import (MetricLogger, StageTimer,
                                           profile_trace, time_block)

__all__ = ["MetricLogger", "StageTimer", "profile_trace", "time_block",
           "debug_dump", "check_finite_tree", "guard_render"]

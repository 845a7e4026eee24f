"""Multiple devices: one process per device in a torch.distributed group
(counterpart of rsem_tpu/parallel)."""

from .distributed import Dist, maybe_initialize, process_read_bounds
from .fast_sharded import (build_theta_chunks, partition_reads_by_hits,
                           run_theta_loop_sharded)
from .mesh import ReadShard, shard_bundle_by_read

__all__ = [
    "Dist",
    "maybe_initialize",
    "process_read_bounds",
    "build_theta_chunks",
    "partition_reads_by_hits",
    "run_theta_loop_sharded",
    "ReadShard",
    "shard_bundle_by_read",
]

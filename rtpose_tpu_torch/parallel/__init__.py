from .mesh import (RowShard, all_gather_objects, all_reduce_sum_, barrier, broadcast_state,
                   collective_counts, init_distributed, is_distributed, process_count,
                   process_index, reset_collective_counts, shutdown, torchrun_env)

__all__ = ["RowShard", "all_gather_objects", "all_reduce_sum_", "barrier", "broadcast_state",
           "collective_counts", "init_distributed", "is_distributed", "process_count",
           "process_index", "reset_collective_counts", "shutdown", "torchrun_env"]

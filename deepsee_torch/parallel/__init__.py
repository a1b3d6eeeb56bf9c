"""Data parallelism over processes (`distributed`), port of the data-parallel
half of deepsee_tpu/parallel/."""

from deepsee_torch.parallel.distributed import (all_reduce_grads, all_reduce_mean, barrier,
                                                broadcast_module_state, gather_rows,
                                                init_distributed, is_main_process, joined,
                                                local_device, per_rank_batch, rank,
                                                rank_rows, world_size)

__all__ = ["all_reduce_grads", "all_reduce_mean", "barrier", "broadcast_module_state",
           "gather_rows", "init_distributed", "is_main_process", "joined", "local_device",
           "per_rank_batch", "rank", "rank_rows", "world_size"]

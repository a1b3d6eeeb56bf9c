"""Parallelism over processes, port of deepsee_tpu/parallel/: the processes,
their (data, model) layout and the data-parallel collectives (`distributed`),
tensor parallelism's plan and shards (`shard`) and its collectives
(`tensor`), spatial sharding's stripes, halos and sums (`spatial`)."""

from deepsee_torch.parallel.distributed import (all_reduce_grads, all_reduce_mean, barrier,
                                                broadcast_module_state, gather_rows,
                                                init_distributed, is_main_process, joined,
                                                local_device, per_rank_batch, rank,
                                                rank_rows, world_size)

__all__ = ["all_reduce_grads", "all_reduce_mean", "barrier", "broadcast_module_state",
           "gather_rows", "init_distributed", "is_main_process", "joined", "local_device",
           "per_rank_batch", "rank", "rank_rows", "world_size"]

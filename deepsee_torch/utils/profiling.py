"""Profiling hooks, port of deepsee_tpu/utils/profiling.py:

  * `trace(logdir)`: torch.profiler over the block (the host and, where
    there is a card, its kernels), written to logdir as a Chrome /
    TensorBoard trace;
  * `timed(fn)`: the median time of fn's calls on the card, by CUDA events
    around each call and a synchronize (PyTorch returns before the card
    finishes);
  * `device_memory_stats()`: live and peak bytes PyTorch holds on each card.
"""

from __future__ import annotations

import contextlib
import os
import statistics
from typing import Callable, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 2,
          **kwargs) -> Dict[str, float]:
    """Median, min and max seconds of `fn(*args, **kwargs)` on the card over
    `iters` calls after `warmup` ones, each call between two CUDA events on
    the current stream; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed() needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return {"median_s": statistics.median(times), "min_s": min(times), "max_s": max(times)}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:<i>": {"bytes_in_use_gb", "peak_bytes_in_use_gb"}} per card,
    from torch.cuda.memory_allocated / max_memory_allocated (GiB); empty
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use_gb": torch.cuda.memory_allocated(i) / 2 ** 30,
                          "peak_bytes_in_use_gb": torch.cuda.max_memory_allocated(i) / 2 ** 30}
            for i in range(torch.cuda.device_count())}

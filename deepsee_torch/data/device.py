"""Host batches onto the device: the port's counterpart of the JAX trainer's
`jax.device_put` (deepsee_tpu/train/loop.py:110-115), which returns before
the copy lands.

`to_device` moves one batch: to a card from pinned memory without blocking
the host.  PyTorch's pinned-memory allocator records an event on each such
copy, so a pinned block is not handed out again before its copy has read
it.  `DevicePrefetcher` feeds a loop: while the work on batch k runs, it
copies batch k+1 with `to_device` on a copy stream of its own, and a CUDA
event recorded after that copy makes the consuming stream wait for it
before it reads the batch.  String and list values (`path`,
`guiding_image_id`) pass through on the host.  On the CPU both are a plain
conversion (`torch.from_numpy`): nothing is pinned there.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def _array(value) -> Optional[torch.Tensor]:
    """`value` as a tensor where it is an array, else None."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    return value if isinstance(value, torch.Tensor) else None


def tensor_to_device(value, device) -> torch.Tensor:
    """A numpy array or tensor on `device`: to a card from pinned memory
    without blocking the host."""
    t = _array(value)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(batch: Dict, device) -> Dict:
    """One batch's arrays as tensors on `device`; other values unchanged."""
    return {key: value if _array(value) is None else tensor_to_device(value, device)
            for key, value in batch.items()}


class DevicePrefetcher:
    """`for batch in DevicePrefetcher(device)(loader)`: the loader's host
    batches as device batches, each copied while the batch before it is in
    use (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def _stage(self, host: Dict):
        """Start batch `host`'s copy: (device batch, the copy's event)."""
        with torch.cuda.stream(self.stream):
            out = to_device(host, self.device)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _ready(self, staged) -> Dict:
        """The staged batch, usable on the current stream."""
        out, event = staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for value in out.values():
            if isinstance(value, torch.Tensor) and value.device.type == "cuda":
                # allocated on the copy stream: not reused while this one reads it
                value.record_stream(stream)
        return out

    def __call__(self, batches: Iterable[Dict]) -> Iterator[Dict]:
        if not self.cuda:
            for batch in batches:
                yield to_device(batch, self.device)
            return
        it = iter(batches)
        host = next(it, None)
        staged = None if host is None else self._stage(host)
        while staged is not None:
            batch = self._ready(staged)
            yield batch  # the consumer enqueues its work on this batch...
            host = next(it, None)  # ...then the next batch's copy starts
            staged = None if host is None else self._stage(host)

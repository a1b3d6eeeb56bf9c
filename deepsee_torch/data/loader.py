"""Batching and background prefetch, an own copy of
deepsee_tpu/data/loader.py (the reference's torch DataLoader,
data/__init__.py:44-53: shuffle unless serial_batches, drop_last when
training).

Samples decode in a thread pool (the native codec and Pillow release the
GIL) inside a sliding window of 2 * num_workers futures taken in index
order, and are collated into numpy arrays; a prefetch thread keeps up to
`prefetch` batches ready.  Samples raising SkipSampleException are skipped
(the reference skips them during evaluation, inference_manager.py:99).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from deepsee_torch.data.datasets import SkipSampleException

_ARRAY_KEYS = ("label", "image_hr", "guiding_label", "guiding_image")


def collate(samples: List[Dict]) -> Dict:
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if key in _ARRAY_KEYS else vals  # paths, ids: lists
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 prefetch: int = 2, shard_index: int = 0, num_shards: int = 1,
                 reseed_dataset: bool = True):
        """shard_index / num_shards: each process reads a disjoint stripe of
        every (globally shuffled) epoch.

        reseed_dataset=False skips the per-epoch dataset.seed() call, for
        auxiliary loaders (the in-training evaluation) that share a dataset
        object with the training loader and must not perturb its
        augmentation stream."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.reseed_dataset = reseed_dataset
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __iter__(self) -> Iterator[Dict]:
        """Abandonment-safe iteration: leaving (or collecting) the iterator
        stops the decode pool and the prefetch thread promptly, so consumers
        that take N batches and leave (the evaluator) neither leak threads
        nor decode the rest of the epoch in the background."""
        indices = self._indices()
        self.epoch += 1
        if self.reseed_dataset and callable(getattr(self.dataset, "seed", None)):
            self.dataset.seed(self.seed + self.epoch)
        stop = threading.Event()

        def fetch(i):
            try:
                return self.dataset[i]
            except SkipSampleException:
                return None

        def batches():
            # a sliding window of futures: decoding stays ~2 * workers ahead
            # of consumption instead of submitting the whole epoch at once
            buf: List[Dict] = []
            pool = ThreadPoolExecutor(self.num_workers)
            try:
                window: deque = deque()
                it = iter(indices)

                def top_up():
                    while len(window) < self.num_workers * 2:
                        try:
                            i = next(it)
                        except StopIteration:
                            return
                        window.append(pool.submit(fetch, i))

                top_up()
                while window and not stop.is_set():
                    sample = window.popleft().result()
                    top_up()
                    if sample is None:
                        continue
                    buf.append(sample)
                    if len(buf) == self.batch_size:
                        yield collate(buf)
                        buf = []
                if buf and not self.drop_last and not stop.is_set():
                    yield collate(buf)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        if self.prefetch <= 0:
            try:
                yield from batches()
            finally:
                stop.set()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()

        def producer():
            try:
                for b in batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        break
            finally:
                # block until the sentinel fits (the consumer is draining) or
                # the consumer has left (stop set)
                while True:
                    try:
                        q.put(end, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is end:
                    break
                yield b
        finally:
            stop.set()

"""Epoch/iteration bookkeeping with resume support: an own copy of
deepsee_tpu/utils/iter_counter.py (reference: util/iter_counter.py).  Under a
process group only rank 0 writes its files (every rank keeps the counts).

Tracks epochs, samples and wall time; persists `iter.txt` (epoch, sample
within the epoch, samples so far) for continue_train; appends the
evaluation histories `fid_iter.txt` and `metrics_iter.txt`; modular triggers for
the periodic actions (:123-138): a trigger fires when the count of samples
so far crosses a multiple of its frequency.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Iterator

import numpy as np

from deepsee_torch.config import Experiment
from deepsee_torch.parallel import distributed


class IterationCounter:
    def __init__(self, exp: Experiment, dataset_size: int, continue_train: bool = False):
        self.exp = exp
        tc = exp.train
        self.dataset_size = dataset_size
        self.batch_size = tc.batch_size
        self.total_epochs = tc.niter + tc.niter_decay
        self.epoch_iter = 0  # samples into the current epoch
        self.writes = distributed.is_main_process()
        self.checkpoints_dir = os.path.join(exp.checkpoints_dir, exp.name)
        if self.writes:
            os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.iter_record_path = os.path.join(self.checkpoints_dir, "iter.txt")
        self.first_epoch = 1
        self.total_steps_so_far = 0
        self.time_per_iter = 0.0
        if continue_train and os.path.exists(self.iter_record_path):
            try:
                vals = np.loadtxt(self.iter_record_path, delimiter=",")
                self.first_epoch = int(vals[0])
                self.epoch_iter = int(vals[1])
                self.total_steps_so_far = int(vals[2])
                print(f"Resuming from epoch {self.first_epoch} at iteration {self.epoch_iter}")
            except (ValueError, IndexError, OSError) as e:  # a damaged record: start fresh
                print(f"Could not load iteration record ({e}); restarting")
        self.epoch_start_time = self.last_iter_time = time.time()
        self.current_epoch = self.first_epoch

    def training_epochs(self) -> Iterator[int]:
        return iter(range(self.first_epoch, self.total_epochs + 1))

    def record_epoch_start(self, epoch: int) -> None:
        self.epoch_start_time = self.last_iter_time = time.time()
        self.epoch_iter = 0
        self.current_epoch = epoch

    def record_one_iteration(self) -> None:
        now = time.time()
        self.time_per_iter = (now - self.last_iter_time) / self.batch_size
        self.last_iter_time = now
        self.total_steps_so_far += self.batch_size
        self.epoch_iter += self.batch_size

    def record_epoch_end(self) -> None:
        elapsed = time.time() - self.epoch_start_time
        if self.writes:
            print(f"End of epoch {self.current_epoch} / {self.total_epochs} "
                  f"\t Time Taken: {elapsed:.0f} sec")
        self.record_current_iter()

    def record_current_iter(self) -> None:
        if not self.writes:
            return
        np.savetxt(self.iter_record_path,
                   (self.current_epoch, self.epoch_iter, self.total_steps_so_far),
                   delimiter=",", fmt="%d")

    def append_eval_history(self, filename: str, value) -> None:
        """One "epoch,samples so far,value" line of a history file."""
        if not self.writes:
            return
        with open(os.path.join(self.checkpoints_dir, filename), "a") as f:
            f.write(f"{self.current_epoch},{self.total_steps_so_far},{value}\n")

    def _history_line(self, split: str, num_samples: int) -> str:
        stamp = datetime.datetime.now().strftime("%Y/%m/%d-%H:%M:%S")
        return (f"time={stamp},split={split},num_samples={num_samples},"
                f"epoch={self.current_epoch:03d},"
                f"total_steps_so_far={self.total_steps_so_far:010d},")

    def _append(self, filename: str, msg: str) -> str:
        if not self.writes:
            return msg
        with open(os.path.join(self.checkpoints_dir, filename), "a") as f:
            f.write(msg + os.linesep)
        print(msg)
        return msg

    def record_fid(self, fid: float, split: str, num_samples: int) -> str:
        """Append one fid_iter.txt line (util/iter_counter.py:100-108)."""
        return self._append("fid_iter.txt", self._history_line(split, num_samples) + f"fid={fid}")

    def record_metrics(self, metrics: dict, split: str, num_samples: int) -> str:
        """Append one metrics_iter.txt line (util/iter_counter.py:110-121):
        only the keys that contain psnr, ssim or rmse."""
        return self._append("metrics_iter.txt", self._history_line(split, num_samples) + ",".join(
            f"{k}={v}" for k, v in metrics.items() if "psnr" in k or "ssim" in k or "rmse" in k))

    def _due(self, freq: int) -> bool:
        return freq > 0 and (self.total_steps_so_far % freq) < self.batch_size

    def needs_printing(self) -> bool:
        return self._due(self.exp.train.print_freq)

    def needs_displaying(self) -> bool:
        return self._due(self.exp.train.display_freq)

    def needs_saving(self) -> bool:
        return self._due(self.exp.train.save_latest_freq)

    def needs_evaluation(self) -> bool:
        return self._due(self.exp.train.evaluation_freq)

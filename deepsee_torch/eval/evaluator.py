"""The evaluation harness, port of deepsee_tpu/eval/evaluator.py (reference:
managers/inference_manager.py): a batched no-grad sweep collecting PSNR,
SSIM, MS-SSIM, RMSE and LPIPS per sample and the Inception pool3
activations for FID, the per-sample CSV, the fid_stats .npz files and the
FID-500 fallback on a numerical failure (inference_manager.py:124-129).

Per batch one sweep computes the fake image, every metric and both
activation sets on the system's device, with the generator and the encoder
in eval mode and under torch.inference_mode.  `run` keeps two batches in
flight, as the JAX evaluator's pipeline_depth = 2: each host batch is
copied to the card from pinned memory without blocking, each batch's small
result dict is copied back into pinned buffers without blocking behind a
CUDA event, and the host reads batch N's results only after it has enqueued
batch N+1.

The metric networks (LPIPS's AlexNet, the Inception) run in full float32:
TF32 is turned off around them (`strict_float32`), so FID and LPIPS do not
depend on the process's TF32 setting.  The generator runs as the caller set
it up.

Across ranks (deepsee_tpu/eval/evaluator.py:37-57, :271-285): each data
rank sweeps its loader stripe, at most ceil(num_samples / W) samples for W
data ranks, and `run` gathers every data rank's per-sample metrics, LPIPS
rows and pool3 activations (`distributed.gather_rows` over the data group,
in data-rank order) before the means and the FID, so the result covers
num_samples on every rank.  (The model ranks of one data index sweep the
same stripe.)  Only rank 0 writes the
per-sample CSV (its own stripe's rows, as the JAX evaluator's main host)
and the fid_stats files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from deepsee_torch.config import Experiment
from deepsee_torch.data import DataLoader, DevicePrefetcher, create_dataset, to_device
from deepsee_torch.eval import fid as fid_mod
from deepsee_torch.eval.lpips import load_lpips
from deepsee_torch.eval.metrics import MetricsAccumulator, batch_metrics
from deepsee_torch.parallel import distributed
from deepsee_torch.system import SRSystem

__all__ = ["InferenceEvaluator", "MetricsCSVWriter", "evaluate_set", "get_validation_loader",
           "strict_float32"]


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """cuDNN convolutions and cuBLAS matmuls in full float32 (TF32 off)
    inside the block; the previous settings after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def _eval_mode(nets) -> Iterator[None]:
    """The networks in eval mode inside the block, each in its previous mode
    after it."""
    modes = [net.training for net in nets]
    for net in nets:
        net.eval()
    try:
        yield
    finally:
        for net, mode in zip(nets, modes):
            net.train(mode)


def get_validation_loader(exp: Experiment, batch_size: Optional[int] = None) -> DataLoader:
    """The loader over the *_val dirs (deepsee_tpu/eval/evaluator.py:60-73;
    evaluation.py:202-217): phase "val", in file order, the last batch
    kept; each rank reads its stripe."""
    if not (exp.data.label_dir_val and exp.data.image_dir_val):
        raise ValueError("label_dir_val / image_dir_val required for validation evaluation")
    val_exp = exp.replace(data=dataclasses.replace(
        exp.data, label_dir=exp.data.label_dir_val, image_dir=exp.data.image_dir_val,
        phase="val"))
    return DataLoader(create_dataset(val_exp, phase="val"), batch_size or exp.train.batch_size,
                      shuffle=False, drop_last=False, shard_index=distributed.data_rank(),
                      num_shards=distributed.data_world())


def evaluate_set(evaluator: "InferenceEvaluator", loader) -> Dict[str, float]:
    """`evaluator.run(loader)` with the reference's exhaustion fallback
    (evaluation.py:220-262: StopIteration -> FID 500)."""
    try:
        return evaluator.run(loader)
    except StopIteration:
        print("[!Exception] iterator exhausted during evaluation; "
              "logging default FID 500.0 and continuing...")
        return {"FID": 500.0}


class MetricsCSVWriter:
    """Per-sample metrics CSV (evaluation.py:159-199)."""

    def __init__(self, folder: str, columns):
        os.makedirs(folder, exist_ok=True)
        self.path = os.path.join(folder, "metrics.csv")
        self.file = open(self.path, "w")
        self.append_line(columns)

    def append_line(self, row) -> None:
        self.file.write(",".join(map(str, row)) + os.linesep)
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class InferenceEvaluator:
    """Evaluates `system`'s networks as they are (weights in the modules) on
    `num_samples` samples of a loader of NHWC numpy batch dicts (a "path"
    list per batch names the CSV rows)."""

    pipeline_depth = 2  # batches in flight in `run`

    def __init__(self, system: SRSystem, num_samples: int, write_details: bool = False,
                 folder_out: Optional[str] = None, compute_fid: bool = True,
                 compute_lpips: bool = True, inception_weights: Optional[str] = None,
                 alexnet_weights: Optional[str] = None,
                 lpips_lin_weights: Optional[str] = None):
        self.system = system
        self.device = system.device
        self.num_samples = num_samples
        self.write = write_details
        self.folder_out = folder_out
        self.compute_fid = compute_fid
        self.compute_lpips = compute_lpips
        self.writer = None
        if write_details and not folder_out:
            raise ValueError("write_details needs folder_out")
        if write_details and distributed.is_main_process():
            self.writer = MetricsCSVWriter(folder_out,
                                           ["ID", "PSNR", "SSIM", "MSSSIM", "RMSE", "LPIPS"])
        if compute_fid:
            self.inception, self.fid_exact = fid_mod.load_inception(inception_weights,
                                                                    device=self.device)
        if compute_lpips:
            self.lpips, self.lpips_exact = load_lpips(lpips_lin_weights, alexnet_weights,
                                                      device=self.device)

    def _nets(self):
        return [n for n in (self.system.generator, self.system.encoder) if n is not None]

    # -- one batch ----------------------------------------------------------

    def _infer(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        # sr_model.py:85-91 'inference': no_noise; the independent model
        # takes the mini (LR) style path unless full_style_image, the guided
        # one always encodes its full style image
        cfg = self.system.cfg
        use_full = cfg.model_variant == "guided" or cfg.full_style_image
        pre = self.system.preprocess(batch)
        fake, _ = self.system.generate(pre, use_full=use_full, no_noise=True)
        return fake, pre["image_hr"]

    def _metrics(self, fake: torch.Tensor, real: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = batch_metrics(fake, real)
        with strict_float32():
            if self.compute_lpips:
                out["lpips"] = self.lpips(fake, real)
            if self.compute_fid:
                out["act_fake"] = fid_mod.inception_pool3(self.inception, fake)
                out["act_real"] = fid_mod.inception_pool3(self.inception, real)
        return out

    def sweep(self, batch) -> Dict[str, torch.Tensor]:
        """One batch (a dict of device tensors) through generate, every
        metric, LPIPS and both activation sets: per-sample device tensors."""
        with _eval_mode(self._nets()), torch.inference_mode():
            return self._metrics(*self._infer(batch))

    def run_batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fake, real) (B, H, W, 3) of one host batch."""
        with _eval_mode(self._nets()), torch.inference_mode():
            return self._infer(to_device(batch, self.device))

    def _to_host(self, m: Dict[str, torch.Tensor]):
        """Start the copy of a batch's results to the host: (buffers, the
        event after which they hold the values, None off the card)."""
        if self.device.type != "cuda":
            return m, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in m.items()}
        for k, v in m.items():
            host[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # -- the sweep ------------------------------------------------------------

    def run(self, dataloader: Iterable) -> Dict[str, float]:
        start = time.time()
        metric_names = ["psnr", "ssim", "ms_ssim", "rmse"] + (
            ["lpips"] if self.compute_lpips else [])
        rows: Dict[str, list] = {name: [] for name in metric_names}
        act_fake, act_real = [], []
        pending: deque = deque()  # (paths, host buffers, event)

        def drain_one():
            paths, host, event = pending.popleft()
            if event is not None:
                event.synchronize()
            m = {k: v.numpy() for k, v in host.items()}
            for name in metric_names:
                rows[name].append(m[name])
            if self.compute_fid:
                act_fake.append(m["act_fake"])
                act_real.append(m["act_real"])
            if self.writer is not None:
                for i in range(len(m["psnr"])):
                    self.writer.append_line([
                        os.path.splitext(os.path.basename(paths[i]))[0],
                        m["psnr"][i], m["ssim"][i], m["ms_ssim"][i], m["rmse"][i],
                        m["lpips"][i] if self.compute_lpips else ""])

        n_seen = 0
        # each rank sweeps its stripe; together they cover num_samples
        local_target = -(-self.num_samples // distributed.data_world())
        with torch.inference_mode():  # the result copies read inference tensors
            for batch in DevicePrefetcher(self.device)(dataloader):
                if n_seen >= local_target:
                    break
                bsize = int(batch["image_hr"].shape[0])
                host, event = self._to_host(self.sweep(batch))
                pending.append((batch.get("path", [""] * bsize), host, event))
                n_seen += bsize
                while len(pending) >= self.pipeline_depth:
                    drain_one()
            while pending:
                drain_one()

        local = {name: (np.concatenate(v, 0) if v else np.zeros((0,), np.float32))
                 for name, v in rows.items()}
        if self.compute_fid:
            for name, acts in (("act_fake", act_fake), ("act_real", act_real)):
                local[name] = (np.concatenate(acts, 0) if acts
                               else np.zeros((0, fid_mod.POOL3_DIM), np.float32))
        merged = self._merge_ranks(local, local_target)
        # clamp to exactly num_samples: a rank's last batch can overshoot by
        # up to batch_size - 1, the ranks' stripes by W - 1 (the reference
        # sweeps num_samples // batch + 1 batches, inference_manager.py:71;
        # these numbers cover num_samples, whatever the ranks and batch)
        merged = {k: v[:self.num_samples] for k, v in merged.items()}

        acc = MetricsAccumulator()
        for name in metric_names:
            if len(merged[name]):
                acc.add(name, merged[name])

        result: Dict[str, float] = {}
        if self.compute_fid and len(merged["act_fake"]):
            af, ar = merged["act_fake"], merged["act_real"]
            if self.write and self.folder_out and distributed.is_main_process():
                for arr, tag in ((af, "fake"), (ar, "real")):
                    mu, sigma = fid_mod.calculate_statistics(arr)
                    np.savez_compressed(
                        os.path.join(self.folder_out, f"fid_stats_{len(arr)}samples_{tag}.npz"),
                        mu=mu, sigma=sigma)
            try:
                result["FID"] = fid_mod.fid_from_activations(af, ar)
            except Exception as e:  # noqa: BLE001 - the reference logs 500 on any failure
                print(f"FID failed ({e}); logging default 500")
                result["FID"] = 500.0

        result.update(acc.result())
        result["eval_seconds"] = time.time() - start
        return result

    def _merge_ranks(self, local: Dict[str, np.ndarray],
                     local_target: int) -> Dict[str, np.ndarray]:
        """Every rank's rows, in rank order (the JAX evaluator's
        _merge_hosts): the host arrays through `distributed.gather_rows` on
        this evaluator's device (NCCL reduces CUDA tensors), back on the
        host; the local rows as they are in one process."""
        if distributed.data_world() == 1:
            return local
        n_local = len(next(iter(local.values())))
        gathered = distributed.gather_rows(
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k, v in local.items()}, n_local, local_target)
        return {k: v.cpu().numpy() for k, v in gathered.items()}

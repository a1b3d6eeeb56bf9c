"""The trainer, port of deepsee_tpu/train/loop.py (reference: train.py:18-127).

Epoch/iteration loop over the GAN step with:
  * a G step every `d_steps_per_g`-th iteration, a D step every iteration
    (train.py:40-44);
  * the per-epoch TTUR lr decay (trainer_manager.py:76-96);
  * the periodic print / display / save / evaluate triggers of
    IterationCounter (train.py:49-105); an evaluation sweeps
    num_evaluation_samples of a shuffled copy of the training dataset (FID,
    LPIPS and the metrics, with G and E in eval mode), and of the
    validation dirs with evaluate_val_set, and appends fid_iter.txt and
    metrics_iter.txt (train.py:85-105);
  * a crash-safe save of "latest" in a finally block (train.py:119-127).

It runs on one card (or the CPU with device="cpu") on a DataLoader, by
default `make_dataloader()`'s over the preset's dataset (the synthetic one
with dataset="synthetic"), shuffled every epoch from the training seed; any
iterable of NHWC numpy batch dicts with a length will do.  Each batch is
copied to the card while the step before it runs (data/device.py).

Data parallelism (deepsee_tpu/train/loop.py:46-63, :87-108): under a process
group of W ranks (torchrun, one process per card; `python -m
deepsee_torch.train --multihost`) batch_size is the global batch; each rank
reads a disjoint stripe of every globally shuffled epoch, batch_size / W
samples per step, on its own card (cuda:LOCAL_RANK unless a device is
given).  Only rank 0 prints, displays and writes the run directory (a zip
of the sources first, utils/files.py::copy_src), and a barrier follows each
save; each rank evaluates its stripe of
num_evaluation_samples / W samples, and the evaluator gathers the rows.

Tensor parallelism (model_axis > 1): the world is dcn x data x model
ranks; the batch and the loaders' stripes go by data rank (the model ranks
of one data index read the same rows) and the networks' convs are sharded
over the model group (parallel/shard.py).  The evaluation and the display
run replicated networks with the gathered weights (`_inference_system`,
the JAX trainer's eval_variables / host_local_variables): every rank joins
the gather, rank 0 alone writes.

Spatial sharding (partition "spatial", deepsee_tpu/train/loop.py:76-81,
:109-115, :262-310): the model ranks of a data index read the same rows and
the step keeps each rank's stripe of H (train/steps.py); the networks are
whole on every rank, so the checkpoints are one process's files, which load
either way.  The display runs the eval-mode networks on every rank's stripes
and gathers the first sample's whole image; the evaluation runs each rank's
whole images (`spatial.whole`).
"""

from __future__ import annotations

import copy
import os
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from deepsee_torch.config import Experiment, MeshConfig
from deepsee_torch.data import DataLoader, DevicePrefetcher, create_dataset
from deepsee_torch.eval.evaluator import InferenceEvaluator, evaluate_set, get_validation_loader
from deepsee_torch.parallel import distributed, shard, spatial
from deepsee_torch.system import SRSystem
from deepsee_torch.train.state import TrainState, create_train_state, set_epoch_lr
from deepsee_torch.train.steps import make_train_step
from deepsee_torch.utils.checkpoint import CheckpointManager
from deepsee_torch.utils.files import copy_src
from deepsee_torch.utils.iter_counter import IterationCounter
from deepsee_torch.utils.visualizer import Visualizer


class Trainer:
    def __init__(self, exp: Experiment, device: Optional[str | torch.device] = None,
                 continue_train: bool = False):
        if not exp.is_train:
            raise ValueError("Trainer needs a training experiment (is_train=True)")
        check_data_parallel(exp, distributed.world_size())
        if device is None and distributed.world_size() > 1:
            device = distributed.local_device()
        self.exp = exp
        self.continue_train = continue_train
        self.system = SRSystem(exp, device=device)
        self.state: TrainState = create_train_state(self.system)
        self.ckpt = CheckpointManager(exp)
        if distributed.is_main_process():  # a source snapshot per run
            try:
                copy_src(os.path.join(exp.checkpoints_dir, exp.name))
            except OSError as e:
                print(f"copy_src failed: {e}")
        if continue_train and self.ckpt.exists("latest"):
            self.ckpt.restore(self.state, "latest")
            if distributed.is_main_process():
                print(f"Restored checkpoint at step {self.state.step}")
        self.step_gd = make_train_step(self.system, do_g=True)
        self.step_d = (make_train_step(self.system, do_g=False)
                       if exp.train.d_steps_per_g > 1 else None)
        self._gathered: Optional[SRSystem] = None

    def _inference_system(self) -> SRSystem:
        """The system the evaluation and the display run: the training one;
        under tensor parallelism a replicated copy of G and E that takes the
        gathered weights now (every rank calls it)."""
        if distributed.model_world() == 1 or self.exp.mesh.spatial:
            return self.system
        if self._gathered is None:
            self._gathered = SRSystem(self.exp.replace(is_train=False, mesh=MeshConfig()),
                                      device=self.system.device)
        for name in ("generator", "encoder"):
            net = getattr(self.system, name)
            if net is not None:
                getattr(self._gathered, name).load_state_dict(shard.gather_state_dict(net))
        return self._gathered

    def make_dataloader(self) -> DataLoader:
        """The training loader (deepsee_tpu/train/loop.py:87-99): the
        preset's dataset, shuffled every epoch from the training seed; each
        rank reads its stripe, its share of the global batch per step."""
        tc = self.exp.train
        return DataLoader(create_dataset(self.exp, phase="train"),
                          distributed.per_rank_batch(tc.batch_size), shuffle=True,
                          drop_last=True, seed=tc.seed, shard_index=distributed.data_rank(),
                          num_shards=distributed.data_world())

    def _eval_loader(self, dataloader):
        """The periodic training-set evaluation's loader, apart from the live
        training stream (deepsee_tpu/train/loop.py:172-185): a shallow copy
        of the dataset (the file lists shared, its own augmentation Random
        through seed()), shuffled from seed + 7919, no prefetch thread (the
        evaluator takes num_evaluation_samples and leaves).  Batches given
        without a dataset are evaluated as they are."""
        dataset = getattr(dataloader, "dataset", None)
        if dataset is None:
            return dataloader
        tc = self.exp.train
        return DataLoader(copy.copy(dataset), distributed.per_rank_batch(tc.batch_size),
                          shuffle=True, drop_last=True, seed=tc.seed + 7919, num_workers=2,
                          prefetch=0, shard_index=distributed.data_rank(),
                          num_shards=distributed.data_world())

    def run(self, dataloader=None, max_steps: Optional[int] = None) -> TrainState:
        """Train over `dataloader` (by default `make_dataloader()`; any
        iterable of NHWC numpy batch dicts with a length, iterated once per
        epoch) until the last epoch or `max_steps`."""
        exp, tc = self.exp, self.exp.train
        main = distributed.is_main_process()
        if dataloader is None:
            dataloader = self.make_dataloader()
        steps_per_epoch = len(dataloader)
        counter = IterationCounter(exp, steps_per_epoch * tc.batch_size,
                                   continue_train=self.continue_train)
        visualizer = Visualizer(exp)
        evaluator = None  # built at the first evaluation trigger
        eval_loader = self._eval_loader(dataloader)
        val_loader = get_validation_loader(exp) if tc.evaluate_val_set else None
        feed = DevicePrefetcher(self.system.device)
        logs: Dict[str, torch.Tensor] = {}
        try:
            for epoch in counter.training_epochs():
                counter.record_epoch_start(epoch)
                self.state.epoch = epoch
                set_epoch_lr(self.state, epoch)
                for i, batch in enumerate(feed(dataloader)):
                    if i >= steps_per_epoch:
                        break
                    do_g = i % tc.d_steps_per_g == 0
                    step_fn = self.step_gd if do_g or self.step_d is None else self.step_d
                    logs = step_fn(self.state, batch)
                    counter.record_one_iteration()
                    if counter.needs_printing() and main:
                        visualizer.print_current_errors(
                            epoch, counter.epoch_iter, {k: float(v) for k, v in logs.items()},
                            counter.time_per_iter)
                    if counter.needs_displaying():
                        system = self._inference_system()
                        if main or spatial.active():  # every rank joins the stripes' gather
                            self._display(system, visualizer, batch, epoch,
                                          counter.total_steps_so_far)
                    if counter.needs_saving():
                        self.ckpt.save(self.state, "latest")
                        counter.record_current_iter()
                        distributed.barrier()
                    if counter.needs_evaluation() and epoch >= tc.evaluation_start_epoch:
                        system = self._inference_system()
                        if evaluator is None:
                            evaluator = InferenceEvaluator(
                                system, tc.num_evaluation_samples,
                                inception_weights=tc.inception_weights or None,
                                alexnet_weights=tc.alexnet_weights or None)
                        with spatial.whole():
                            result = evaluate_set(evaluator, eval_loader)
                        counter.record_fid(result.get("FID", 500.0), "train",
                                           tc.num_evaluation_samples)
                        counter.record_metrics(result, "train", tc.num_evaluation_samples)
                        if val_loader is not None:
                            with spatial.whole():
                                result = evaluate_set(evaluator, val_loader)
                            counter.record_fid(result.get("FID", 500.0), "validation",
                                               tc.num_evaluation_samples)
                            counter.record_metrics(result, "validation",
                                                   tc.num_evaluation_samples)
                    if max_steps and self.state.step >= max_steps:
                        return self.state
                counter.record_epoch_end()
                if epoch % tc.save_epoch_freq == 0:
                    self.ckpt.save(self.state, str(epoch))
                    distributed.barrier()
        except KeyboardInterrupt:
            if main:
                print("Interrupted: saving 'latest' before exit (train.py:119-127)")
            raise
        except Exception:
            traceback.print_exc()
            raise
        finally:
            try:
                self.ckpt.save(self.state, "latest")
                counter.record_current_iter()
            except Exception as e:  # noqa: BLE001 - report, keep the first error
                print(f"crash-save failed: {e}")
        if main:
            print("Training was successfully finished.")
        return self.state

    def _display(self, system: SRSystem, visualizer: Visualizer, batch: Dict, epoch: int,
                 step: int) -> None:
        """The first sample's label, LR input, eval-mode output and HR image.
        Where maps are striped, every rank runs its stripes and joins the
        gather of the first sample's; rank 0 writes."""
        nets = [n for n in (system.generator, system.encoder) if n is not None]
        for n in nets:
            n.eval()
        try:
            pre = system.preprocess(spatial.shard_rows(batch))
            fake, _ = system.generate(pre, use_full=system.cfg.full_style_image)
        finally:
            for n in nets:
                n.train()
        visuals = {"input_label": pre["label"], "image_lr": pre["image_lr"],
                   "synthesized_image": fake, "real_image": pre["image_hr"]}
        visuals = {k: spatial.gather_rows(v[:1], dim=1)[0] for k, v in visuals.items()}
        if distributed.is_main_process():
            visualizer.display_current_results(
                {k: np.asarray(v.float().cpu()) for k, v in visuals.items()}, epoch, step)


def check_data_parallel(exp: Experiment, world: int) -> None:
    """Raise unless the port runs `exp` over `world` ranks: a layout it has
    (`MeshConfig.check_ported`: data and tensor parallelism, spatial
    sharding that stripes the model's maps evenly) whose ranks, dcn_axis x
    data_axis x model_axis, are the world's processes."""
    mesh = exp.mesh
    mesh.check_ported(exp.model)
    ranks = mesh.n_devices
    if min(mesh.data_axis, mesh.dcn_axis, mesh.model_axis) < 1 or ranks != world:
        layout = (f"data_axis {mesh.data_axis} x dcn_axis {mesh.dcn_axis} = {ranks} "
                  "data-parallel ranks" if mesh.model_axis == 1 else
                  f"data_axis {mesh.data_axis} x dcn_axis {mesh.dcn_axis} x model_axis "
                  f"{mesh.model_axis} = {ranks} ranks")
        raise ValueError(f"{layout}, but the world has {world} process(es); start {ranks} with "
                         f"torchrun --nproc_per_node {ranks} ... --multihost")

"""Training checkpoints in the reference's layout: `<tag>_net_SR.pth`,
`<tag>_net_E.pth` and `<tag>_net_D.pth` ({"model": state_dict}, keys of the
reference's modules, util/util.py:217-237), which
`weights.load_reference_checkpoint` loads into an inference or a training
system; `<tag>_train_state.pth` beside them with both optimizers' states,
the step and epoch counts and the step's random generators; and
`config.json`, the experiment.  Files are written to a temporary name and
renamed, so a crash never leaves half a file.

Replaces deepsee_tpu/utils/checkpoint.py's Orbax checkpoints of the whole
TrainState (the card's machine has no Orbax), with the files of
torch_import.export_reference_checkpoint.

Under a process group only rank 0 writes (the ranks hold the same state);
every rank reads the same files, and a restore then takes the networks from
data rank 0.  The caller puts a barrier after a save where other ranks may
read.  Under tensor parallelism every rank first joins the gather of the
networks' shards and of the Adam moments (parallel/shard.py), so the files
are the ones one process writes, and a restore cuts them to this rank's
shards: a checkpoint moves between layouts either way.
"""

from __future__ import annotations

import os

import torch

from deepsee_torch.config import Experiment
from deepsee_torch.parallel import distributed, shard
from deepsee_torch.train.state import TrainState, broadcast_networks
from deepsee_torch.weights import load_reference_checkpoint, save_reference_checkpoint


class CheckpointManager:
    def __init__(self, exp: Experiment):
        self.exp = exp
        self.dir = os.path.join(exp.checkpoints_dir, exp.name)
        self._config_written = False

    def _state_path(self, tag: str) -> str:
        return os.path.join(self.dir, f"{tag}_train_state.pth")

    def exists(self, tag: str = "latest") -> bool:
        return os.path.exists(self._state_path(tag))

    @staticmethod
    def _nets(state: TrainState):
        system = state.system
        nets = {"SR": system.generator, "E": system.encoder, "D": system.discriminator}
        return {tag: net for tag, net in nets.items() if net is not None}

    def save(self, state: TrainState, tag: str = "latest") -> None:
        # every rank joins the gather of the shards (none without tensor parallelism)
        sds = {t: shard.gather_state_dict(n) for t, n in self._nets(state).items()}
        opts = {k: shard.gather_optimizer_state(opt)
                for k, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d))}
        if not distributed.is_main_process():
            return
        os.makedirs(self.dir, exist_ok=True)
        if not self._config_written:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                f.write(self.exp.to_json())
            self._config_written = True
        save_reference_checkpoint(sds, self.dir, tag)
        path = self._state_path(tag)
        torch.save(dict(opts, step=state.step, epoch=state.epoch,
                        generators=state.generators_state()), path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore(self, state: TrainState, tag: str = "latest") -> TrainState:
        """The networks (weights, running statistics, spectral u/v), both
        optimizers, the counts and the generators, in place."""
        if not self.exists(tag):
            raise FileNotFoundError(f"no checkpoint '{tag}' in {self.dir}")
        load_reference_checkpoint(state.system, self.dir, tag, include_d=True)
        saved = torch.load(self._state_path(tag), map_location=state.system.device,
                           weights_only=True)
        state.opt_g.load_state_dict(shard.local_optimizer_state(state.opt_g, saved["opt_g"]))
        state.opt_d.load_state_dict(shard.local_optimizer_state(state.opt_d, saved["opt_d"]))
        state.step, state.epoch = int(saved["step"]), int(saved["epoch"])
        state.load_generators_state({k: v.cpu() for k, v in saved["generators"].items()})
        broadcast_networks(state.system)
        return state

"""Per-block rematerialization of the generator's training forward, port of
the JAX package's `nn.remat` per block (deepsee_tpu/models/generator.py:92-106,
config.py:202-207; the reference's --efficient checkpointing).

`checkpoint_block` runs one generator block under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the forward keeps
only what the policy saves and the backward recomputes the rest.

  * "full": nothing inside the block is saved; the backward runs the block's
    forward again.
  * "convs": the output of every `Conv2d` module is saved (the JAX package's
    `checkpoint_name(y, "conv_out")`, models/layers.py:184-187: the trunk
    convs and the `mlp_shared` convs); the norms, K1, the activations, the
    noise injection and the folded modulation convs (tagged "mod_conv_out"
    there, not saved) are recomputed.  `Conv2d.forward` opens
    `saving_conv_output()` around its conv alone, and a selective-checkpoint
    policy saves the ops run while it is open.

A block's training forward changes state besides its output: the spectral
convs' power iteration writes `weight_u` / `weight_v`, the batch norms write
`running_mean` / `running_var`, and the noise injection draws from the
caller's torch.Generator (which `preserve_rng_state` does not cover: it
restores only the default generators).  A plain recompute would advance all
three a second time and take the gradient through a weight, statistics and
noise the forward did not use.  So each checkpoint carries a replay
(`_Replay`): the forward snapshots those buffers and the generator's state
before it runs; the recompute loads that snapshot, runs, and then puts back
what was there when it started (the state after the forward, unless another
forward ran in between).  The recompute computes what the forward computed,
and u, v, the running statistics and the generator advance once per forward.

Under data parallelism the recompute of a batch norm issues
`SyncModnormTrain`'s all-reduce again (ops/modnorm.py); under "convs" the
policy does not save it (it runs outside a conv), so it runs in the forward
and again in the recompute, as under "full".  Every rank recomputes the
same blocks in the same order in its backward, so the collectives still
pair up across ranks (tests/test_torch_dist_step.py runs both policies over
two ranks).  Under spatial sharding the recompute issues the block's halo
exchanges and K1's statistics collectives again, in the same order on every
rank, and parallel/spatial.py counts them in `replayed` besides.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepsee_torch.parallel import spatial

POLICIES = ("full", "convs")
# the buffers a block's training forward writes
REPLAYED_BUFFERS = ("weight_u", "weight_v", "running_mean", "running_var")

_SAVING = threading.local()


class saving_conv_output:
    """Open around a conv whose output the "convs" policy saves; outside a
    checkpoint it changes nothing."""

    def __enter__(self):
        self.prev = getattr(_SAVING, "on", False)
        _SAVING.on = True

    def __exit__(self, *exc):
        _SAVING.on = self.prev


def _save_conv_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if getattr(_SAVING, "on", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Replay:
    """The state one block's forward changes besides its output: its
    REPLAYED_BUFFERS and the state of the noise generator."""

    def __init__(self, block: nn.Module, generator: Optional[torch.Generator]):
        self.buffers = [b for name, b in block.named_buffers()
                        if name.rpartition(".")[2] in REPLAYED_BUFFERS]
        self.generator = generator
        self.before = None

    def _state(self):
        return ([b.clone() for b in self.buffers],
                None if self.generator is None else self.generator.get_state())

    def _load(self, state) -> None:
        buffers, rng = state
        with torch.no_grad():
            for b, value in zip(self.buffers, buffers):
                b.copy_(value)
        if rng is not None:
            self.generator.set_state(rng)

    @contextlib.contextmanager
    def forward(self):
        self.before = self._state()
        yield

    @contextlib.contextmanager
    def recompute(self):
        now = self._state()
        self._load(self.before)
        try:
            with spatial.replaying():
                yield
        finally:
            self._load(now)


@contextlib.contextmanager
def _chain(*managers):
    with contextlib.ExitStack() as stack:
        for manager in managers:
            stack.enter_context(manager)
        yield


def _contexts(block: nn.Module, generator: Optional[torch.Generator], policy: str):
    """(forward context, recompute context) of one checkpoint: the replay
    outermost, so that its snapshots and loads stay outside the selective
    policy's dispatch modes."""
    replay = _Replay(block, generator)
    if policy == "full":
        return replay.forward(), replay.recompute()
    caching, cached = create_selective_checkpoint_contexts(_save_conv_outputs)
    return _chain(replay.forward(), caching), _chain(replay.recompute(), cached)


def checkpoint_block(block: nn.Module, policy: str, x: torch.Tensor, seg: torch.Tensor,
                     style: Optional[torch.Tensor],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """block(x, seg, style, generator=generator), rematerialized by
    `policy` ("full" or "convs")."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES}, got {policy!r}")
    return checkpoint(block, x, seg, style, generator=generator, use_reentrant=False,
                      context_fn=functools.partial(_contexts, block, generator, policy))

"""Processes and their layout, port of the process half of
deepsee_tpu/parallel/mesh.py (`make_mesh`, `batch_spec` / `shard_batch`:
the batch over the "dcn" x "data" axes, the gradient all-reduce and the
global batch statistics that XLA inserts under jit) and of
deepsee_tpu/utils/files.py::is_main_process.

One process per card, started by torchrun (`python -m torch.distributed.run
--nproc_per_node N ...`), joined by `init_distributed`: NCCL between cards,
gloo on the CPU or where the caller asks for it (gloo also reduces CUDA
tensors, through host memory, so two processes can share one card).  Each
rank holds its rows of the global batch (`per_rank_batch`); what XLA did
implicitly is explicit here:

  * the weights start equal on every rank (`broadcast_module_state` from
    rank 0, after creation and after a restore);
  * the generator's batch statistics cover the global batch: its norms take
    `ops.modnorm.SyncModnormTrain` (statistics, all-reduce, apply) where the
    world has more than one rank;
  * gradients are averaged before each optimizer step (`all_reduce_grads`);
  * random draws are made for the global batch on every rank, from
    generators seeded alike, and each rank keeps its rows (`rank_rows`);
  * the evaluator's per-sample rows are gathered (`gather_rows`).

The layout (`set_model_axis`, make_mesh's devices.reshape(dcn, data,
model)): global rank r has model index r % model_axis and data index
r // model_axis.  Its *model group* is the model_axis consecutive ranks of
its data index, in which every tensor-parallel collective runs
(parallel/tensor.py); its *data group* is the ranks that share its model
index, in which the gradient all-reduce, the logs' mean, the weights'
broadcast and every batch statistic run.  The rows of the global batch are
split by data rank: the model ranks of one data index hold the same rows.
With model_axis 1 (data parallelism alone) the data group is the default
group.

Without a process group every function here is the one-process identity:
world_size() is 1, rank() 0, and the data and model worlds are 1.
Nothing here switches backends or devices behind the caller's back:
NCCL's own error for two ranks on one card is raised as it is.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


# the layout of the default group's ranks: set_model_axis
_LAYOUT: Dict = {"model_axis": 1, "model": None, "data": None, "partition": "tensor"}


def reset_layout() -> None:
    """Back to model_axis 1 (data parallelism alone), the groups dropped."""
    _LAYOUT.update(model_axis=1, model=None, data=None, partition="tensor")


def partition() -> str:
    """How the model group is used: "tensor" (channel shards of the convs,
    parallel/shard.py) or "spatial" (stripes of every map, parallel/spatial.py)."""
    return _LAYOUT["partition"]


def set_model_axis(model_axis: int, partition: str = "tensor") -> None:
    """Lay the default group's ranks out as (data, model) with `model_axis`
    model ranks per data index, and make the two groups of this rank; the
    model group serves `partition`.  Every rank calls it, with the same
    values: each group is made by all ranks (torch.distributed.new_group),
    even those outside it."""
    world = world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the world of {world} "
                         "process(es)")
    if model_axis == _LAYOUT["model_axis"]:
        _LAYOUT["partition"] = partition
        return
    reset_layout()
    _LAYOUT["partition"] = partition
    if model_axis == 1:
        return
    model_groups = [dist.new_group(list(range(d * model_axis, (d + 1) * model_axis)))
                    for d in range(world // model_axis)]
    data_groups = [dist.new_group(list(range(m, world, model_axis)))
                   for m in range(model_axis)]
    r = rank()
    _LAYOUT.update(model_axis=model_axis, model=model_groups[r // model_axis],
                   data=data_groups[r % model_axis])


def model_world() -> int:
    """Ranks in this rank's model group (model_axis); 1 without a group."""
    return _LAYOUT["model_axis"] if world_size() > 1 else 1


def model_rank() -> int:
    """This rank's model index: its place in its model group."""
    return rank() % model_world()


def data_world() -> int:
    """Ranks in this rank's data group (dcn_axis x data_axis)."""
    return world_size() // model_world()


def data_rank() -> int:
    """This rank's data index: the stripe of the global batch it holds."""
    return rank() // model_world()


def model_group():
    """The process group of this rank's model group (None: there is none)."""
    return _LAYOUT["model"]


def data_group():
    """The process group of this rank's data group (None: the default group,
    where the model axis is 1)."""
    return _LAYOUT["data"]


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that owns the run directory's side effects: the
    checkpoint, config.json, loss_log.txt, the HTML page, iter.txt and the
    evaluation histories (deepsee_tpu/utils/files.py::is_main_process)."""
    return rank() == 0


def local_device() -> torch.device:
    """cuda:LOCAL_RANK, the card torchrun gives this process; raises where
    the machine has no such card."""
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"local rank {index} needs cuda:{index}, but {count} CUDA "
                           "device(s) are visible")
    return torch.device("cuda", index)


def init_distributed(backend: Optional[str] = None, device: str | torch.device = "cuda") -> str:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); return the backend.

    backend None picks NCCL where `device` is a CUDA device and gloo on the
    CPU; "gloo" on CUDA shares cards between ranks (collectives go through
    host memory).  With NCCL the current CUDA device becomes this rank's
    card (`local_device`) first."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed reads torchrun's environment; {missing} not set "
                           "(start the program with python -m torch.distributed.run)")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    reset_layout()
    if backend == "nccl":
        if not cuda:
            raise ValueError("the NCCL backend needs a CUDA device")
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://")
    return backend


@contextlib.contextmanager
def joined(multihost: bool, device: str | torch.device) -> Iterator[str | torch.device]:
    """A CLI's run: with `multihost`, inside the process group of torchrun's
    environment (`init_distributed`), on this rank's card where `device` is
    "cuda", with one line naming rank, backend and device; the group left
    after.  Yields the device to run on."""
    if not multihost:
        yield device
        return
    backend = init_distributed(device=device)
    if device == "cuda":
        device = local_device()
    print(f"multihost: rank {rank()} of {world_size()}, backend {backend}, device {device}",
          flush=True)
    try:
        yield device
    finally:
        reset_layout()
        dist.destroy_process_group()


def per_rank_batch(global_batch: int) -> int:
    """This rank's rows of a global batch (deepsee_tpu/train/loop.py:99-108):
    its share of the data ranks'; raises unless they divide it."""
    world = data_world()
    if global_batch % world:
        raise ValueError(f"global batch_size {global_batch} not divisible by {world} processes "
                         "(the data-parallel ranks)")
    return global_batch // world


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _flat_groups(tensors: Iterable[torch.Tensor]):
    """The tensors grouped by (device, dtype), in order."""
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def broadcast_module_state(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` (running statistics, spectral
    u/v) set to those of data rank `src` of this rank's data group, one
    flat broadcast per device and type.  Under tensor parallelism each model
    index broadcasts its own shards."""
    if data_world() == 1:
        return
    src_rank = src * model_world() + model_rank()
    with torch.no_grad():
        for group in _flat_groups(module.state_dict(keep_vars=True).values()):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src_rank, group=data_group())
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.detach().copy_(v.view_as(t))


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Each parameter's .grad replaced by the mean over the data group: one
    flat float32 buffer, all-reduced (sum) and divided by the data world.

    Each rank's gradient is that of the mean loss over its own rows, so the
    mean of the ranks' gradients is the gradient of the mean loss over the
    global batch.  Through the generator's synchronized batch norms this
    holds too: their backward divides the all-reduced sums by the global
    count, which scales each rank's share by the world size, and the
    division here undoes it."""
    world = data_world()
    if world == 1:
        return
    dtypes = {p.grad.dtype for p in params}
    if dtypes != {torch.float32}:
        raise ValueError(f"all_reduce_grads takes float32 gradients, got {dtypes}")
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=data_group())
    flat.div_(world)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def all_reduce_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-dim float tensors (a step's losses) -> their means over the data
    group, as the JAX package's logs are over the global batch (the model
    ranks of a data index hold the same logs)."""
    world = data_world()
    if world == 1 or not values:
        return values
    flat = torch.stack([v.detach().float() for v in values.values()])
    dist.all_reduce(flat, group=data_group())
    flat.div_(world)
    return dict(zip(values, flat.unbind()))


def rank_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) in one process.  Under a process group of W data ranks
    whose draws come from generators seeded alike, draw((W * B,) +
    shape[1:]) -- the global batch's numbers -- and keep this data rank's
    rows [r * B, (r + 1) * B): data rank r's rows are then the ones a single
    process draws for rows rB.. of the same global batch.  Each rank draws W
    times the numbers it keeps."""
    shape = tuple(int(d) for d in shape)
    world = data_world()
    if world == 1:
        return draw(shape)
    b, r = shape[0], data_rank()
    return draw((world * b,) + shape[1:])[r * b:(r + 1) * b]


def gather_rows(tensors: Dict[str, torch.Tensor], n_valid: int,
                target: int) -> Dict[str, torch.Tensor]:
    """Every data rank's rows of each tensor, in data-rank order, gathered
    over the data group (the JAX evaluator's _merge_hosts,
    deepsee_tpu/eval/evaluator.py:271-285).  Ranks may hold
    different counts: each pads (or cuts) its first `n_valid` rows to
    `target`, writes them into block `rank` of a zero buffer of world *
    target rows with a validity mask beside them, and one all-reduce sum
    per tensor acts as the all-gather; it is exact, as every other rank
    adds zeros.  Rows beyond each rank's count are dropped after it."""
    world = data_world()
    if world == 1:
        return {k: v[:n_valid] for k, v in tensors.items()}
    r, n = data_rank(), min(n_valid, target)
    device = next(iter(tensors.values())).device
    valid = torch.zeros(world * target, device=device)
    valid[r * target:r * target + n] = 1.0
    dist.all_reduce(valid, group=data_group())
    keep = valid > 0.5
    out = {}
    for key, v in tensors.items():
        buf = torch.zeros((world * target,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
        buf[r * target:r * target + n] = v[:n]
        dist.all_reduce(buf, group=data_group())
        out[key] = buf[keep]
    return out

"""Tensor parallelism's collectives, written out: the all-reduces and
all-gathers that GSPMD inserted implicitly around the column/row shards of
deepsee_tpu/parallel/mesh.py (`_spec_for`, `system_sharding`).

Four autograd functions over the model group (`distributed.model_group`):

  * `copy`:    identity forward, all-reduce (sum) backward.  A column layer
               whose input is replicated takes it through copy: each rank's
               gradient of that input is a partial sum over its output
               channels.  A replicated parameter used on a channel slice
               (SEAN's alphas, noise_middle's weight) goes through copy too.
  * `reduce`:  all-reduce (sum) forward, identity backward: a row conv's
               partial output, a loss summed over channel shards, a
               spectral norm's partial dot products.
  * `gather`:  all-gather along a dimension forward, this rank's slice
               backward: a channel-sharded activation for a replicated
               consumer.
  * `scatter`: this rank's slice forward, all-gather backward: a replicated
               activation for a channel-local consumer (K1 on the block
               input, a row conv's input).

Beside them, outside autograd, `all_reduce_max`: the elementwise maximum
over the model group, the whole layer's maxima of an int8 conv's block
(ops/int8conv.py::int8_conv_sharded; the JAX package's global max-reduce);
and `all_reduce_batch_max`, the one collective here over the data group:
an int8 conv's activation maxima over the global batch, where data ranks
hold its rows (the JAX mesh program's max over its data axis).

Rank r of n holds the contiguous block [r * C / n, (r + 1) * C / n) of a
sharded dimension of C.  These five, the non-autograd twins
(`all_reduce_values`, `all_gather_values`), `mean_replicated_grads` and
`all_reduce_batch_max` are the only places where a tensor-parallel
collective runs; each counts its collectives (`counts`:
calls and the bytes of the tensor each produces) and the channel slices it
copies into channels_last memory (`layout_copies`).  Every rank of a model
group (data group) must call them with the same shapes, in the same order.
With one model rank (data rank) each is the identity and counts nothing.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from deepsee_torch.parallel import distributed

KINDS = ("copy", "reduce", "gather", "scatter", "max", "batch_max")
counts: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in KINDS}
layout_copies = {"slice": 0}


def reset_counts() -> None:
    for kind in KINDS:
        counts[kind].update(calls=0, bytes=0)
    layout_copies["slice"] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()


def _channels_last(t: torch.Tensor) -> bool:
    return t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
        memory_format=torch.channels_last)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t as a view the collective reads element for element: NHWC for a
    channels_last NCHW tensor; a contiguous copy otherwise."""
    if _channels_last(t):
        return t.permute(0, 2, 3, 1)
    return t.contiguous()


def _all_reduce(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A new tensor: the sum of t over the model group, in t's layout."""
    out = t.clone(memory_format=torch.channels_last if _channels_last(t)
                  else torch.contiguous_format)
    dist.all_reduce(_dense(out), group=distributed.model_group())
    _count(kind, out)
    return out


def _all_gather(kind: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' t concatenated along `dim`; a 4-D channels_last
    input gives a channels_last output."""
    n = distributed.model_world()
    if _channels_last(t):
        nhwc = t.permute(0, 2, 3, 1)
        parts = [torch.empty_like(nhwc) for _ in range(n)]
        dist.all_gather(parts, nhwc, group=distributed.model_group())
        out = torch.cat(parts, dim=(0, 3, 1, 2)[dim]).permute(0, 3, 1, 2)
    else:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=distributed.model_group())
        out = torch.cat(parts, dim=dim)
    _count(kind, out)
    return out


def local_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of `dim`; a 4-D channels_last tensor's block
    copied into channels_last memory (counted in layout_copies), any other
    a view."""
    n, r = distributed.model_world(), distributed.model_rank()
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {n} "
                         "model ranks")
    c = t.shape[dim] // n
    out = t.narrow(dim, r * c, c)
    if t.dim() == 4 and dim == 1:
        layout_copies["slice"] += 1
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce("copy", g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce("reduce", x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        return _all_gather("gather", x, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        return local_slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather("scatter", g, ctx.dim), None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    return _Copy.apply(x) if distributed.model_world() > 1 else x


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group; the gradient passed as it is."""
    return _Reduce.apply(x) if distributed.model_world() > 1 else x


def gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model ranks' blocks of `dim` concatenated; the gradient's block."""
    return _Gather.apply(x, dim) if distributed.model_world() > 1 else x


def scatter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of `dim`; the gradient gathered from every block."""
    return _Scatter.apply(x, dim) if distributed.model_world() > 1 else x


def all_gather_values(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """`gather` outside autograd (running statistics, spectral vectors,
    checkpoints), counted as a gather."""
    if distributed.model_world() == 1:
        return x
    with torch.no_grad():
        return _all_gather("gather", x.detach(), dim)


def local_param(p: torch.Tensor) -> torch.Tensor:
    """A replicated per-channel parameter (C,) as a layer on this rank's
    channel block uses it: its block, with the gradient summed over the
    model group (`copy`), since each rank's reaches only its own block."""
    return local_slice(copy(p), 0)


def mean_replicated_grads(params) -> None:
    """Each replicated parameter's .grad (one without a `tp_shard`) replaced
    by its mean over the model group: one flat all-reduce, counted as a
    reduce.  Every model rank computes these gradients in full, equal up to
    the order of atomic adds in some CUDA backwards (max pooling's, a
    conv's): the mean makes them, and so the replicated parameters, equal
    bit for bit on every rank."""
    n = distributed.model_world()
    if n == 1:
        return
    replicated = [p for p in params if getattr(p, "tp_shard", None) is None]
    if not replicated:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in replicated])
    dist.all_reduce(flat, group=distributed.model_group())
    _count("reduce", flat)
    flat.div_(n)
    for p, g in zip(replicated, flat.split([p.numel() for p in replicated])):
        p.grad = g.view_as(p)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: the elementwise maximum of x over the model group,
    outside autograd, counted as "max"."""
    if distributed.model_world() == 1:
        return x
    with torch.no_grad():
        out = x.detach().clone()
        dist.all_reduce(_dense(out), op=dist.ReduceOp.MAX, group=distributed.model_group())
        _count("max", out)
        return out


def all_reduce_batch_max(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: the elementwise maximum of x over the data group (the
    ranks that hold the other rows of the global batch), outside autograd,
    counted as "batch_max"."""
    if distributed.data_world() == 1:
        return x
    with torch.no_grad():
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=distributed.data_group())
        _count("batch_max", out)
        return out


def all_reduce_values(x: torch.Tensor) -> torch.Tensor:
    """`reduce` outside autograd, counted as a reduce."""
    if distributed.model_world() == 1:
        return x
    with torch.no_grad():
        return _all_reduce("reduce", x.detach())


# -- the conv layouts --------------------------------------------------------------

COLUMN, ROW = "column", "row"


def conv_input(x: torch.Tensor, sharded: bool, mode) -> torch.Tensor:
    """x (channel-sharded where `sharded`) as a conv of `mode` (COLUMN, ROW
    or None: replicated) takes it: a column or replicated conv the whole
    channels (a column one through `copy`), a row conv this rank's block."""
    if mode == ROW:
        return x if sharded else scatter(x)
    if sharded:
        x = gather(x)
    return copy(x) if mode == COLUMN else x


def full(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """x with every channel (gathered where it is sharded)."""
    return gather(x) if sharded else x

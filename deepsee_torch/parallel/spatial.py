"""Spatial sharding's collectives, written out: the halo exchanges and the
global (H, W) reductions that GSPMD inserted implicitly when the JAX package
sharded H over the mesh's "model" axis (deepsee_tpu/parallel/mesh.py
`batch_spec(spatial=True)`, `shard_batch`; config.py's partition "spatial").

Under `use_mesh(MeshConfig(..., partition="spatial"))` the parameters stay
replicated and every activation is cut into horizontal stripes: rank m of
the model group (`distributed.model_group`, model_axis ranks) holds rows
[m * H / M, (m + 1) * H / M) of each map of H rows (`Rows.even`).  A window
of k rows at stride s and padding p (a conv, a pool) keeps the *owner rule*:
rank m computes output row o when s * o falls in its rows, and the last rank
also every o with s * o >= H (`Rows.window`).  Strides of 2 on stripes of
even height keep the stripes even; the discriminator's 4x4 windows at
padding 2 make them uneven (256 -> 129 -> 65 rows: the last rank holds the
extra ones), and its callers carry the layout (`Rows`) from layer to layer.

The collectives, each over the model group, each counted in `counts` (calls
and the bytes of the tensor each produces) and, inside a remat recompute,
in `replayed` too:

  * `window`: the rows a window needs from the neighbouring stripes (the
    halo), as many ranks up or down as it takes, zeros at the global top and
    bottom only (or, with edge "reflect", rows 1.. and ..H-2 of the first and
    last stripes mirrored there); an autograd function whose backward sends
    each halo row's gradient back and adds it into its owner's row, and a
    mirrored row's into its source ("halo", "halo_grad");
  * `reduce`: all-reduce (sum) forward, identity backward: a loss's local
    sum ("reduce");
  * `sum_shared`: all-reduce forward and backward: a sum over H whose
    result feeds every stripe again (the style matrix, "shared");
  * K1's statistics: the instance norms' (count, mean, M2) partials and the
    backward's sums over the model group, the batch norms' over the whole
    world, data x model ("stats", "stats_grad"; ops/modnorm.py's split
    modes);
  * `sum_replicated_grads`: each replicated parameter's gradient, a
    partial sum over this rank's stripe, summed over the model group
    ("grads");
  * `gather_rows`: the stripes put back together, for the display and
    checks ("gather");
  * `all_reduce_max`: the elementwise maximum, outside autograd: an int8
    conv's maxima over the whole map (ops/int8conv.py::int8_conv_striped,
    "max").

Every rank of a model group must call them with the same layouts, in the
same order.  With one model rank, or outside `use_mesh` (and inside
`whole()`), nothing here is active and every map is whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepsee_torch.ops import modnorm as mn
from deepsee_torch.parallel import distributed

KINDS = ("halo", "halo_grad", "reduce", "shared", "stats", "stats_grad", "grads", "gather",
         "max")
EDGES = ("zeros", "reflect")
counts: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in KINDS}
# the collectives issued again by a remat recompute (models/remat.py), also in counts
replayed = {"calls": 0, "bytes": 0}
_STATE = {"whole": 0, "replaying": 0}


def reset_counts() -> None:
    for kind in KINDS:
        counts[kind].update(calls=0, bytes=0)
    replayed.update(calls=0, bytes=0)


def _count(kind: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += nbytes
    if _STATE["replaying"]:
        replayed["calls"] += 1
        replayed["bytes"] += nbytes


def use_mesh(mesh) -> None:
    """Lay the world out as `mesh` says (`distributed.set_model_axis`) and,
    where its partition is "spatial", stripe every map over the model
    group from now on.  Every rank calls it, with the same mesh."""
    distributed.set_model_axis(mesh.model_axis, mesh.partition)


def active() -> bool:
    """Whether maps are striped over a model group of more than one rank."""
    return (distributed.partition() == "spatial" and not _STATE["whole"]
            and distributed.model_world() > 1)


@contextlib.contextmanager
def whole():
    """Inside: every map is whole, as in one process (the in-training
    evaluation, which runs each rank's whole images)."""
    _STATE["whole"] += 1
    try:
        yield
    finally:
        _STATE["whole"] -= 1


@contextlib.contextmanager
def replaying():
    """Inside: the collectives are a remat recompute's, counted in
    `replayed` as well."""
    _STATE["replaying"] += 1
    try:
        yield
    finally:
        _STATE["replaying"] -= 1


# -- layouts -------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rows:
    """The stripes of a map: rank m holds global rows [bounds[m], bounds[m+1])."""

    bounds: Tuple[int, ...]

    @staticmethod
    def even(height: int, n: Optional[int] = None) -> "Rows":
        n = distributed.model_world() if n is None else n
        if height % n:
            raise ValueError(f"a map of {height} rows does not split into {n} even stripes")
        return Rows(tuple(m * height // n for m in range(n + 1)))

    @property
    def height(self) -> int:
        return self.bounds[-1]

    def span(self, m: Optional[int] = None) -> Tuple[int, int]:
        m = distributed.model_rank() if m is None else m
        return self.bounds[m], self.bounds[m + 1]

    def window(self, k: int, s: int, p: int) -> "Rows":
        """The output's stripes under the owner rule for a window of k rows,
        stride s, padding p; raises where a rank would hold none."""
        out_h = (self.height + 2 * p - k) // s + 1
        bounds = (0,) + tuple(-(-lo // s) for lo in self.bounds[1:-1]) + (out_h,)
        if any(b >= e for b, e in zip(bounds[:-1], bounds[1:])):
            raise ValueError(f"a {k}x{k} window at stride {s}, padding {p} on the stripes "
                             f"{self.bounds} leaves a rank without rows ({bounds}): use fewer "
                             "model ranks for this map")
        return Rows(bounds)

    def reads(self, k: int, s: int, p: int) -> List[Tuple[int, int]]:
        """Per rank, the input rows [a, b) its output stripe reads (global
        indices; below 0 and from the height on are the zero padding)."""
        out = self.window(k, s, p)
        return [(s * lo - p, s * (hi - 1) - p + k) for lo, hi in zip(out.bounds[:-1],
                                                                   out.bounds[1:])]


def rows_of(x: torch.Tensor) -> Rows:
    """The even stripes of a striped NCHW map x (this rank's rows)."""
    return Rows.even(x.shape[2] * distributed.model_world())


def global_height(h: int) -> int:
    """The height of a map whose even stripes have h rows (h where nothing
    is striped)."""
    return h * distributed.model_world() if active() else h


def local_height(height: int) -> int:
    """This rank's rows of an evenly striped map of `height` rows."""
    if not active():
        return height
    lo, hi = Rows.even(height).span()
    return hi - lo


def stripe_block(mat: np.ndarray, in_rows: Rows, out_rows: Rows) -> np.ndarray:
    """This rank's block of a global (out, in) resampling matrix: its output
    rows against its input rows.  Raises where an output row of the stripe
    takes a weight from outside the input stripe (a resize that is not
    local to the stripes)."""
    (i0, i1), (o0, o1) = in_rows.span(), out_rows.span()
    rows = mat[o0:o1]
    if np.any(rows[:, :i0]) or np.any(rows[:, i1:]):
        raise ValueError(f"the resize of {mat.shape[1]} to {mat.shape[0]} rows reads outside "
                         f"the stripe [{i0}, {i1}) for the output rows [{o0}, {o1})")
    return rows[:, i0:i1]


def stripe(t, dim: int):
    """This rank's even stripe of a whole tensor or numpy array along `dim`."""
    lo, hi = Rows.even(t.shape[dim]).span()
    if isinstance(t, np.ndarray):
        return np.take(t, np.arange(lo, hi), axis=dim)
    return t.narrow(dim, lo, hi - lo)


def shard_rows(batch: Dict) -> Dict:
    """A batch of NHWC arrays with this rank's stripe of H kept in every
    entry of 3 or more dimensions (images, label maps), the others as they
    are (deepsee_tpu/parallel/mesh.py::shard_batch with spatial=True).  The
    identity where nothing is striped."""
    if not active():
        return batch
    return {k: (stripe(v, 1) if getattr(v, "ndim", 0) >= 3 else v) for k, v in batch.items()}


def full_rows_draw(draw, shape: Sequence[int], dim: int = 1) -> torch.Tensor:
    """draw(shape) of a striped map, as one process draws it: the draw for
    the whole map (`dim` times the model ranks) and this rank's stripe of
    it."""
    shape = tuple(int(d) for d in shape)
    if not active():
        return draw(shape)
    whole_shape = shape[:dim] + (shape[dim] * distributed.model_world(),) + shape[dim + 1:]
    return stripe(draw(whole_shape), dim)


# -- the halo ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _halo_plan(bounds: Tuple[int, ...], k: int, s: int, p: int):
    """(reads per rank, rows each rank sends from its top and its bottom,
    rows of each rank's top and bottom halo): all ranks compute the same."""
    rows = Rows(bounds)
    reads, n, height = rows.reads(k, s, p), len(bounds) - 1, bounds[-1]
    top = bottom = 0
    for j in range(n):
        lo, hi = rows.span(j)
        for i, (a, b) in enumerate(reads):
            if i < j and min(b, hi) > lo:
                if a > lo:
                    raise ValueError(f"rank {i} reads rows {a}..{b} inside rank {j}'s stripe")
                top = max(top, min(b, hi) - lo)
            if i > j and max(a, lo) < hi:
                if b < hi:
                    raise ValueError(f"rank {i} reads rows {a}..{b} inside rank {j}'s stripe")
                bottom = max(bottom, hi - max(a, lo))
    halo_up = max(lo - max(a, 0) for (lo, _), (a, _) in
                  zip((rows.span(m) for m in range(n)), reads))
    halo_down = max(min(b, height) - hi for (_, hi), (_, b) in
                    zip((rows.span(m) for m in range(n)), reads))
    return tuple(reads), top, bottom, max(0, halo_up), max(0, halo_down)


@functools.lru_cache(maxsize=None)
def _mirrors(bounds: Tuple[int, ...], k: int, s: int, p: int):
    """Per rank, the local rows that a reflect edge mirrors above and below
    its stripe (the slab's first and last rows): global row -i reads row i,
    row H - 1 + i reads row H - 1 - i, as jnp.pad / F.pad's "reflect" does.
    Raises, the same on every rank, where a mirrored row lies outside the
    stripe that reads it (a stripe too short for the reflection)."""
    rows = Rows(bounds)
    height, out = bounds[-1], []
    for m, (a, b) in enumerate(rows.reads(k, s, p)):
        lo, hi = rows.span(m)
        src = [-g for g in range(a, min(b, 0))], [2 * (height - 1) - g
                                                   for g in range(max(a, height), b)]
        if any(not lo <= r < hi for r in src[0] + src[1]):
            raise ValueError(f"a reflect edge of {p} rows (window {k}x{k}, stride {s}) mirrors "
                             f"rows {src[0] + src[1]} of the map of {height}, outside the "
                             f"stripe [{lo}, {hi}) that reads them: the stripes are too short "
                             "for the reflection; use fewer model ranks for this map")
        out.append(tuple(tuple(r - lo for r in rs) for rs in src))
    return tuple(out)


def _edges(t: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """(B, top + bottom, W, C): t's (NHWC) first `top` rows, zeros after
    them where t has fewer, then its last `bottom` rows, zeros before them
    where it has fewer."""
    h = t.shape[1]
    parts = [t[:, :top]]
    if h < top:
        parts.append(t.new_zeros((t.shape[0], top - h) + t.shape[2:]))
    if h < bottom:
        parts.append(t.new_zeros((t.shape[0], bottom - h) + t.shape[2:]))
    parts.append(t[:, max(0, h - bottom):] if bottom else t[:, :0])
    return torch.cat(parts, dim=1).contiguous()


def _all_gather(kind: str, t: torch.Tensor) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(distributed.model_world())]
    dist.all_gather(parts, t, group=distributed.model_group())
    _count(kind, torch.cat([p.reshape(-1) for p in parts]))
    return parts


class _Window(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bounds, k, s, p, edge):
        rows = Rows(bounds)
        reads, top, bottom, up, down = _halo_plan(bounds, k, s, p)
        m, n, height = distributed.model_rank(), len(bounds) - 1, bounds[-1]
        mirrors = _mirrors(bounds, k, s, p)[m] if edge == "reflect" else ((), ())
        xn = x.permute(0, 2, 3, 1)
        parts = (_all_gather("halo", _edges(xn, top, bottom)) if top or bottom else None)
        a, b = reads[m]
        pieces = []

        def edge_rows(r, mirrored):
            if mirrored:
                return xn.index_select(1, torch.tensor(mirrored, device=xn.device))
            return xn.new_zeros((xn.shape[0], r) + xn.shape[2:])

        if a < 0:
            pieces.append(edge_rows(min(b, 0) - a, mirrors[0]))
        for j in range(n):
            lo, hi = rows.span(j)
            r0, r1 = max(a, lo, 0), min(b, hi, height)
            if r0 >= r1:
                continue
            if j == m:
                pieces.append(xn[:, r0 - lo:r1 - lo])
            elif j > m:   # from j's top rows
                pieces.append(parts[j][:, r0 - lo:r1 - lo])
            else:         # from j's bottom rows
                base = top + bottom - (hi - r0)
                pieces.append(parts[j][:, base:base + r1 - r0])
        if b > height:
            pieces.append(edge_rows(b - max(a, height), mirrors[1]))
        ctx.plan = (bounds, reads, up, down, x.shape[2], mirrors)
        slab = torch.cat(pieces, dim=1).permute(0, 3, 1, 2)
        return slab.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        bounds, reads, up, down, h, mirrors = ctx.plan
        rows, m, n, height = Rows(bounds), distributed.model_rank(), len(bounds) - 1, bounds[-1]
        gn = g.permute(0, 2, 3, 1)
        lo, hi = rows.span(m)
        a, b = reads[m]
        out = gn.new_zeros((gn.shape[0], h) + gn.shape[2:])
        r0, r1 = max(a, lo), min(b, hi)
        if r0 < r1:
            out[:, r0 - lo:r1 - lo] += gn[:, r0 - a:r1 - a]
        # a mirrored row's gradient into its source row
        for mirrored, first in ((mirrors[0], 0), (mirrors[1], max(a, height) - a)):
            if mirrored:
                out.index_add_(1, torch.tensor(mirrored, device=gn.device),
                               gn[:, first:first + len(mirrored)])
        if up or down:
            # my top halo rows [lo - up, lo) and bottom ones [hi, hi + down), zeros
            # where I read none of them
            halo = gn.new_zeros((gn.shape[0], up + down) + gn.shape[2:])
            t0, t1 = max(a, 0, lo - up), lo
            if t0 < t1:
                halo[:, up - (lo - t0):up] = gn[:, t0 - a:t1 - a]
            d0, d1 = hi, min(b, height, hi + down)
            if d0 < d1:
                halo[:, up:up + d1 - d0] = gn[:, d0 - a:d1 - a]
            parts = _all_gather("halo_grad", halo.contiguous())
            for i in range(n):
                if i == m:
                    continue
                ilo, ihi = rows.span(i)
                for start, first in ((ilo - up, 0), (ihi, up)):
                    length = up if first == 0 else down
                    s0, s1 = max(start, lo), min(start + length, hi)
                    if s0 < s1:
                        out[:, s0 - lo:s1 - lo] += parts[i][:, first + s0 - start:
                                                            first + s1 - start]
        gx = out.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return gx, None, None, None, None, None


def window(x: torch.Tensor, k: int, s: int, p: int, rows: Optional[Rows] = None,
           edge: str = "zeros") -> torch.Tensor:
    """The rows of the global map that this rank's output stripe of a k-row
    window (stride s, padding p) reads: its own rows, the neighbours' halo
    rows and, beyond the global top and bottom (never between the
    stripes), zeros or with `edge` "reflect" the mirrored rows 1.. and
    ..H-2 (which the first and last stripes must hold).  A window over the
    result with padding 0 along H gives this rank's output rows.  `rows` is
    x's layout (its even stripes where None).  Any dtype the process
    group's all-gather takes (an int8 conv's x_q too)."""
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    if k == 1 and s == 1 and p == 0:   # a 1x1 conv reads its own rows
        return x
    rows = rows_of(x) if rows is None else rows
    if tuple(x.shape[2:3]) != (rows.span()[1] - rows.span()[0],):
        raise ValueError(f"this rank's stripe has {x.shape[2]} rows, the layout {rows.bounds} "
                         f"gives it {rows.span()}")
    return _Window.apply(x, rows.bounds, k, s, p, edge)


# -- reductions --------------------------------------------------------------------


def _all_reduce(kind: str, t: torch.Tensor, group=None) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=distributed.model_group() if group is None else group)
    _count(kind, out)
    return out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce("reduce", x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce("shared", x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce("shared", g)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group; the gradient passed as it is (a loss's
    local sum: each rank's graph then carries its own rows' share)."""
    return _Reduce.apply(x) if active() else x


def sum_shared(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of a partial sum over this rank's rows,
    whose result every stripe uses again (the style matrix): its gradient,
    each rank's share, summed over the group too."""
    return _SumShared.apply(x) if active() else x


def mean(t: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """The float32 mean of a striped NCHW map over every rank's rows: the
    local sum, summed over the model group, over the global count (`rows`
    its layout, its even stripes where None).  t.mean() where nothing is
    striped."""
    if not active():
        return t.float().mean()
    height = rows.height if rows is not None else t.shape[2] * distributed.model_world()
    return reduce(t.float().sum()) / (t.numel() // t.shape[2] * height)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: the elementwise maximum of t over the model group,
    outside autograd, counted as "max"."""
    with torch.no_grad():
        out = t.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=distributed.model_group())
    _count("max", out)
    return out


def sum_replicated_grads(params: Sequence[torch.Tensor]) -> None:
    """Each parameter's .grad, a partial sum over this rank's rows, replaced
    by the sum over the model group: one flat float32 all-reduce."""
    if not active() or not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    flat = _all_reduce("grads", flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def gather_rows(t: torch.Tensor, dim: int = 2, rows: Optional[Rows] = None) -> torch.Tensor:
    """The stripes of every model rank along `dim`, put back together (not
    differentiable); stripes of uneven `rows` are padded for the gather."""
    if not active():
        return t
    rows = Rows.even(t.shape[dim] * distributed.model_world()) if rows is None else rows
    n = len(rows.bounds) - 1
    most = max(rows.span(m)[1] - rows.span(m)[0] for m in range(n))
    with torch.no_grad():
        t = t.detach().movedim(dim, 0)
        pad = t.new_zeros((most - t.shape[0],) + t.shape[1:])
        parts = _all_gather("gather", torch.cat([t, pad]).contiguous())
        whole = torch.cat([parts[m][:rows.span(m)[1] - rows.span(m)[0]] for m in range(n)])
    return whole.movedim(0, dim)


# -- K1's statistics across the stripes ------------------------------------------------


def _stats_reduce(kind: str, group):
    def all_reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, group=group)
        _count(kind, t)
    return all_reduce


def instance_modnorm(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                     lrelu: bool = False, rows: Optional[Rows] = None):
    """K1's instance mode with each sample's statistics over every stripe of
    the model group (ops/modnorm.py::SplitInstanceModnorm): (out, mean,
    rstd), the statistics (B, C) and equal on every rank.  `rows` is x's
    layout (its even stripes where None), whose height gives the count."""
    height = rows.height if rows is not None else x.shape[2] * distributed.model_world()
    group = distributed.model_group()
    return mn.SplitInstanceModnorm.apply(
        x, mod, eps, lrelu, float(height * x.shape[3]), distributed.model_rank(),
        distributed.model_world(), _stats_reduce("stats", group),
        _stats_reduce("stats_grad", group))


def batch_modnorm(x: torch.Tensor, mod: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                  lrelu: bool = False):
    """K1's batch statistics over every rank's rows and stripes, data x
    model (the whole world): ops/modnorm.py::SyncModnormTrain on the default
    group.  Every map it normalizes is evenly striped."""
    return mn.modnorm_train_sync(x, mod, eps=eps, lrelu=lrelu, group=None,
                                 all_reduce=_stats_reduce("stats", None),
                                 grad_all_reduce=_stats_reduce("stats_grad", None))


def batch_group():
    """(group, ranks) of a batch statistic: the data group, or the whole
    world where maps are striped."""
    if active():
        return None, distributed.world_size()
    return distributed.data_group(), distributed.data_world()


def check_layout(model, mesh) -> None:
    """Raise ValueError, naming the constraint, unless the spatial layout
    `mesh` stripes the maps of `model` (a ModelConfig) as the port trains
    them: its model axis must divide start_size (G's and the mini trunk's
    first maps, and so every map of G and E evenly) and crop_size / 16 (the
    VGG19's relu5_1 map, the perceptual loss's coarsest), and leave every
    rank rows of each of the discriminator's maps (its 4x4 windows at
    padding 2 make its stripes uneven)."""
    n = mesh.model_axis
    for what, rows in (("start_size", model.start_size),
                       ("crop_size / 16 (the VGG19's relu5_1 map)", model.crop_size / 16)):
        if rows != int(rows) or int(rows) % n:
            raise ValueError(f"partition 'spatial': model_axis {n} does not divide {what} = "
                             f"{rows:g}; the stripes of every map must be even")
    discriminator_rows(model, Rows.even(model.crop_size, n))  # raises on an empty stripe


def discriminator_rows(model, rows: Rows) -> List[List[Rows]]:
    """The layouts of the multiscale discriminator's outputs (per scale, per
    layer, the logit last) for an input of layout `rows`: 4x4 windows at
    padding 2, stride 2 but for the last two layers, and a 3x3 stride-2
    pool between the scales (models/discriminator.py)."""
    strides = [2] * (model.n_layers_d - 1) + [1, 1]
    out = []
    for scale in range(model.num_d):
        if scale:
            rows = rows.window(3, 2, 1)
        layers, r = [], rows
        for s in strides:
            r = r.window(4, s, 2)
            layers.append(r)
        out.append(layers)
    return out

"""The traced window: torch.profiler over the window of a `--trace 1` run,
reduced to the device's operations (kernels, copies, sets) and the
benchmark's own host ranges.

  busy_s     the union of the device operations' intervals inside the
             window (an operation on the copy stream that overlaps a kernel
             counts once)
  window_s   the window's length, from the benchmark's "window" range
  breakdown  the device operations that took most time, by name, and the
             idle gaps summed by the benchmark range open on the host when
             each gap began

The profiler records the host's operators too (its CPU activity), which
the host ranges need; that slows the host (PERF.md §5).  Nothing is
written to disk: the events are read from the profiler in memory.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "window"
# the benchmark's host ranges; a gap takes the innermost one open at its start
RANGES = ("preprocess", "encode_style", "generate", "to_host", "wait", "loop", "g_update",
          "d_update", "optimizer", "step")

Interval = Tuple[float, float]


class Tracer:
    """`with tracer:` profiles when `on`; `tracer.range(name)` marks a host
    range (a no-op when off)."""

    def __init__(self, on: bool, device_type: str = "cuda"):
        self.on = on
        self.cuda = device_type == "cuda"
        self.prof = None
        self.ops: List[Tuple[str, float, float]] = []     # (name, start s, end s)
        self.ranges: List[Tuple[str, float, float]] = []
        self.window: Optional[Interval] = None

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts, record_shapes=False, with_stack=False)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            self._read()
        return False

    def _read(self) -> None:
        from torch.autograd import DeviceType

        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CPU:
                if name == WINDOW:
                    self.window = (start, end)
                elif name in RANGES:
                    self.ranges.append((name, start, end))
            elif not e.is_user_annotation() and name not in RANGES and name != WINDOW:
                # the device's copies of the host ranges are annotations, not work
                self.ops.append((name, start, end))
        if self.window is None:
            raise RuntimeError("the trace holds no window range")
        lo, hi = self.window
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in self.ops if e > lo and s < hi]

    # -- reductions ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Interval]:
        return merge((s, e) for _, s, e in self.ops)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def seconds_of(self, names: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of `names`
        as a whole identifier."""
        pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names))
                             + r")(?![A-Za-z0-9_])")
        return sum(e - s for n, s, e in self.ops if pattern.search(n))

    def device_ops(self, top: int = 10) -> List[list]:
        totals: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            totals[n[:160]] += e - s
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        lo, hi = self.window
        busy = self.busy()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        totals: Dict[str, float] = defaultdict(float)
        for (s, e), name in zip(gaps, self._host_ranges([s for s, _ in gaps])):
            totals[name] += e - s
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def _host_ranges(self, times: List[float]) -> List[str]:
        """For each of the sorted `times`, the innermost benchmark range open
        on the host then ("other" where none is): one sweep over the ranges'
        starts and ends, which nest on the one host thread."""
        marks = sorted([(s, 1, n) for n, s, _ in self.ranges]
                       + [(e, 0, n) for n, _, e in self.ranges])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(marks) and marks[i][0] <= t:
                _, opens, name = marks[i]
                if opens:
                    stack.append(name)
                elif name in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(name)]
                i += 1
            out.append(stack[-1] if stack else "other")
        return out


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]

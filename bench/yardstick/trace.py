"""Reduce a ``torch.profiler`` trace and the program's spans to the numbers
the per-layer readers take.

The profiler (CUDA activity) records each device operation (kernel, copy,
fill) with its device interval, and each CUDA runtime call that launched
one (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with its host time;
both carry one correlation id.  The program's ``TRACER`` records its layer
spans on the host clock (``time.perf_counter``).  A device operation
belongs to a layer when the call that launched it ran inside one of the
layer's spans: the work the layer launched, whatever kernels do it.

The profiler stamps events in nanoseconds of the wall clock
(``time.time_ns``); ``clock_offset_ns`` maps the spans onto it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Optional

NAME_CHARS = 96


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the closest of a few
    reads (the smallest gap between the two reads wins)."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _union(intervals) -> list:
    """Merged, sorted copy of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _length(merged) -> int:
    return sum(e - s for s, e in merged)


class DeviceTrace:
    """The device operations of one profiled window, and the spans that
    launched them.

    ``window_ns``: (start, end) of the profiled window on the profiler's
    clock.  ``spans``: the program's ``TRACER`` spans (dicts with ``name``,
    ``t0``, ``dur`` in perf_counter seconds, ``attrs``)."""

    def __init__(self, events, spans: list, window_ns: tuple,
                 offset_ns: int):
        w0, w1 = window_ns
        self.window_ns = (w0, w1)
        self.ops = []                # (start, end, name, correlation)
        self.launch_ns = {}          # correlation -> host time of the call
        for name, is_device, s, e, corr in events:
            if is_device:
                s, e = max(s, w0), min(e, w1)
                if e > s:
                    self.ops.append((s, e, name, corr))
            elif corr:
                self.launch_ns[corr] = s
        self.spans = [dict(sp, s_ns=int(sp["t0"] * 1e9) + offset_ns,
                           e_ns=int((sp["t0"] + sp["dur"]) * 1e9) + offset_ns)
                      for sp in spans]
        self.spans = [sp for sp in self.spans
                      if sp["e_ns"] > w0 and sp["s_ns"] < w1]
        self.busy = _union((s, e) for s, e, _, _ in self.ops)

    @classmethod
    def from_profiler(cls, prof, spans: list, window_ns: tuple,
                      offset_ns: int) -> "DeviceTrace":
        """Read the raw kineto events of a stopped ``torch.profiler``
        (``prof.events()`` builds a tree of them, which takes tens of
        seconds at hundreds of thousands of events)."""
        from torch.autograd import DeviceType
        rows = []
        for e in prof.profiler.kineto_results.events():
            is_dev = e.device_type() == DeviceType.CUDA
            corr = e.correlation_id()
            if not is_dev and not corr:
                continue
            rows.append((e.name(), is_dev, e.start_ns(), e.end_ns(), corr))
        return cls(rows, spans, window_ns, offset_ns)

    # -------------------------------------------------------------- device

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return _length(self.busy) / 1e9

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def attributed(self) -> bool:
        """Whether launches were recorded, so ops can be given to spans."""
        return any(c in self.launch_ns for _, _, _, c in self.ops)

    def layer_device_s(self, span_name: str, keep=None) -> Optional[float]:
        """Device seconds (the union of their intervals) of the operations
        launched inside spans named ``span_name`` (and, if given, for which
        ``keep(span)`` holds).  None where no launch was recorded."""
        if not self.attributed:
            return None
        iv = sorted((sp["s_ns"], sp["e_ns"]) for sp in self.spans
                    if sp["name"] == span_name and (keep is None or keep(sp)))
        if not iv:
            return None
        starts = [s for s, _ in iv]
        mine = []
        for s, e, _, corr in self.ops:
            t = self.launch_ns.get(corr)
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= iv[j][1]:
                mine.append((s, e))
        return _length(_union(mine)) / 1e9

    # ----------------------------------------------------------- breakdown

    def top_ops(self, n: int = 10) -> list:
        """[[name, device seconds]] of the operations that took the most
        time, summed by name."""
        by = defaultdict(int)
        for s, e, name, _ in self.ops:
            by[name[:NAME_CHARS]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10, outside: str = "bench") -> list:
        """[[host activity, idle seconds]]: the device's idle time in the
        window, summed by the innermost span running on the host at the
        middle of each idle gap (``outside`` where none ran)."""
        w0, w1 = self.window_ns
        gaps, t = [], w0
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        spans = sorted(self.spans, key=lambda sp: sp["s_ns"])
        by = defaultdict(int)
        active, i = [], 0            # spans open at the sweep's time
        for s, e in gaps:            # in time order
            mid = (s + e) // 2
            while i < len(spans) and spans[i]["s_ns"] <= mid:
                active.append(spans[i])
                i += 1
            active = [sp for sp in active if sp["e_ns"] >= mid]
            best = min(active, key=lambda sp: sp["e_ns"] - sp["s_ns"],
                       default=None)
            by[best["name"] if best else outside] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

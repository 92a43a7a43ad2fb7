"""Lightweight span tracing for the d-HNSW stack.

A single process-global :data:`TRACER` records spans into a bounded,
thread-safe ring buffer.  When disabled (the default) every entry point is
a no-op that allocates nothing: :meth:`Tracer.span` returns a shared null
context manager and :meth:`Tracer.add` / :meth:`Tracer.event` return
immediately, so traced code paths stay bit-identical and ledger-identical
to untraced ones.

Span model
----------
Each span is a plain dict::

    {"name": "compute.fetch", "tier": "compute", "t0": <perf_counter s>,
     "dur": <s>, "id": 17, "parent": 12, "trace": <64-bit id>,
     "tid": 0, "attrs": {"bytes": 4096.0, ...}}

Parentage is tracked per-thread: entering a ``with TRACER.span(...)``
block pushes the span onto that thread's stack, so nested calls (serve
window -> dispatch -> compute round -> pool verb) form a tree without any
explicit plumbing.  Externally-timed spans (queue waits, harvested
server-side spans) are attached with :meth:`Tracer.add` /
:meth:`Tracer.add_span`.

Tiers are free-form strings; the conventional taxonomy is documented in
``docs/observability.md`` (serve / compute / pool / net / server / kernel
/ bench), and what this package adds to it (child spans, counters, host
waits, ``device_s``, the clock offset, the cost of tracing) in
``docs/torch_observability.md``.

Tail-based sampling
-------------------
``configure(tail=True)`` switches the ring from "last N spans" to "the
interesting traces": spans still record always-on and cheap, but a
non-root span is *staged* per-thread instead of entering the ring, and
only when its root closes is the whole trace either promoted (root +
staged children append together) or discarded.  A root is promoted when
it is explicitly marked (``keep=True`` attr), touched an error or
failover (``error``/``failover`` attrs), or its latency — ``model_s``
attr when present (deterministic modeled seconds), wall ``dur``
otherwise — reaches an adaptive quantile threshold over a rolling
window of recent roots.  The promoted root carries ``why_kept`` in its
attrs (``marked`` / ``error`` / ``latency`` / ``warmup``); ``kept`` and
``discarded`` count root decisions and :meth:`Tracer.health` exposes
them next to ring occupancy, so the ring holds the p99 outliers instead
of the last N requests and silent span loss stays visible.

Counters and waits
------------------
:meth:`Tracer.count` adds to a named counter of the innermost open
``with`` span on the thread; :meth:`Tracer.wait` times a block in which
the host waits for the device (a readback, a blocking upload, a
synchronize) and counts it as ``host_syncs`` / ``sync_wait_s`` (and per
site, ``host_syncs.<site>`` / ``sync_wait_s.<site>``).  When a span
closes its counters land in its ``attrs`` and are added to the enclosing
span's, so a root span holds the totals of its whole tree.  With no open
span a count is dropped.  :meth:`Tracer.count_later` defers a count
that the device computes (a host tensor a copy fills behind the device's
work); it rolls up with the spans and :meth:`Tracer.settle` adds it once
the host has waited for the device anyway.

Device time and the clock
-------------------------
:meth:`Tracer.device_span` is a span that also records a pair of CUDA
events on the device's current stream around its body; nothing waits on
them while the program runs.  :meth:`Tracer.snapshot` resolves each
pair the device has already passed into ``attrs["device_s"]`` and leaves
the others pending, so a snapshot (a metrics scrape) never waits for the
device; :meth:`Tracer.save` waits for every pair.  ``configure`` records
``clock_offset_ns``, the wall clock (``time.time_ns``, which
``torch.profiler`` stamps in) minus ``perf_counter`` (the spans' ``t0``),
so a saved trace sits on a profiler's timeline without a second
estimate; ``save`` writes it under ``otherData``.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        """Enter without side effects and return self."""
        return self

    def __exit__(self, *exc: object) -> bool:
        """Exit without recording; never swallows exceptions."""
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        """Discard attribute updates."""
        return self

    @property
    def span_id(self) -> int:
        """Null spans have id 0 (meaning "no span")."""
        return 0


_NULL = _NullSpan()


class _Span:
    """Live span context manager; records itself into the tracer on exit."""

    __slots__ = ("_tracer", "name", "tier", "attrs", "t0", "span_id",
                 "parent_id", "counts", "later", "outer")

    def __init__(self, tracer: "Tracer", name: str, tier: str, attrs: Dict[str, Any]):
        """Bind the span to *tracer*; nothing is recorded until ``__exit__``."""
        self._tracer = tracer
        self.name = name
        self.tier = tier
        self.attrs = attrs
        self.t0 = 0.0
        self.span_id = 0
        self.parent_id = 0
        self.counts: Dict[str, float] = {}
        self.later: List[tuple] = []
        self.outer: Optional["_Span"] = None

    def __enter__(self) -> "_Span":
        """Allocate an id, push onto the thread's parent stack, start the clock."""
        tr = self._tracer
        self.parent_id = tr._current_id()
        self.outer = getattr(tr._tls, "open", None)
        self.span_id = next(tr._ids)
        tr._tls.span_id = self.span_id
        tr._tls.open = self
        self.t0 = time.perf_counter()
        return self

    def set(self, **attrs: Any) -> "_Span":
        """Merge extra attributes into the span before it closes."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, *exc: object) -> bool:
        """Stop the clock, pop the parent stack, roll the counters up into
        the enclosing span, and record the span."""
        dur = time.perf_counter() - self.t0
        tr = self._tracer
        tr._tls.span_id = self.parent_id
        tr._tls.open = self.outer
        if self.counts:
            self.attrs.update(self.counts)
            if self.outer is not None:
                _add_counts(self.outer.counts, self.counts)
        if self.later and self.outer is not None:
            self.outer.later.extend(self.later)
        tr._record(self.name, self.tier, self.t0, dur, self.span_id, self.parent_id, self.attrs)
        return False


def _add_counts(into: Dict[str, float], counts: Dict[str, float]) -> None:
    for key, n in counts.items():
        into[key] = into.get(key, 0) + n


class _DeviceSpan(_Span):
    """A span that also brackets its body with two CUDA events on the
    device's current stream (none on the CPU); ``Tracer.snapshot``
    resolves them into ``attrs["device_s"]``."""

    __slots__ = ("_device", "_start")

    def __init__(self, tracer: "Tracer", name: str, tier: str,
                 attrs: Dict[str, Any], device: Any):
        super().__init__(tracer, name, tier, attrs)
        self._device = device
        self._start = None

    def __enter__(self) -> "_DeviceSpan":
        super().__enter__()
        if self._device.type == "cuda":
            import torch
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc: object) -> bool:
        if self._start is not None:
            import torch
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._tracer._pending.append((self.attrs, self._start, end))
        return super().__exit__(*exc)


class _Wait:
    """Times one block in which the host waits for the device and counts
    it in the innermost open span (see ``Tracer.wait``)."""

    __slots__ = ("_tracer", "site", "t0")

    def __init__(self, tracer: "Tracer", site: str):
        self._tracer = tracer
        self.site = site
        self.t0 = 0.0

    def __enter__(self) -> "_Wait":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dt = time.perf_counter() - self.t0
        sp = getattr(self._tracer._tls, "open", None)
        if sp is not None:
            _add_counts(sp.counts, {
                "host_syncs": 1, "sync_wait_s": dt,
                "host_syncs." + self.site: 1,
                "sync_wait_s." + self.site: dt})
        return False


class Tracer:
    """Thread-safe bounded span recorder with a per-thread parent stack."""

    def __init__(self, capacity: int = 65536):
        """Create a disabled tracer with room for *capacity* spans."""
        self.enabled = False
        self.capacity = int(capacity)
        self.trace_id = 0
        self.dropped = 0
        self.tail = False
        self.tail_quantile = 0.95
        self.tail_window = 256
        self.kept = 0
        self.discarded = 0
        self._root_durs: deque = deque(maxlen=self.tail_window)
        self._spans: deque = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._phase: Optional[str] = None
        self._pending: deque = deque(maxlen=self.capacity)
        self.clock_offset_ns = 0

    # -- lifecycle ---------------------------------------------------------

    def configure(
        self,
        enabled: bool = True,
        capacity: Optional[int] = None,
        trace_id: Optional[int] = None,
        tail: Optional[bool] = None,
        tail_quantile: Optional[float] = None,
        tail_window: Optional[int] = None,
    ) -> "Tracer":
        """Enable (or reconfigure) tracing and reset the buffer.

        *trace_id* defaults to a fresh 63-bit id derived from the wall
        clock; pass an explicit value for reproducible tests.  *tail*
        switches on tail-based sampling (see module docstring):
        *tail_quantile* is the adaptive latency threshold over a rolling
        window of *tail_window* recent root latencies.
        """
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            if tail is not None:
                self.tail = bool(tail)
            if tail_quantile is not None:
                self.tail_quantile = float(tail_quantile)
            if tail_window is not None:
                self.tail_window = int(tail_window)
            self._spans = deque(maxlen=self.capacity)
            self._ids = itertools.count(1)
            self._tids = {}
            self.dropped = 0
            self.kept = 0
            self.discarded = 0
            self._root_durs = deque(maxlen=self.tail_window)
            self._tls = threading.local()
            self._phase = None
            self._pending = deque(maxlen=self.capacity)
            self.clock_offset_ns = wall_offset_ns()
            if trace_id is not None:
                self.trace_id = int(trace_id)
            elif not self.trace_id:
                self.trace_id = (time.time_ns() & 0x7FFFFFFFFFFFFFFF) | 1
            self.enabled = bool(enabled)
        return self

    def disable(self) -> None:
        """Turn tracing off and drop all buffered spans."""
        with self._lock:
            self.enabled = False
            self.tail = False
            self._spans.clear()
            self._pending.clear()
            self._root_durs.clear()
            self.kept = 0
            self.discarded = 0
            self._tls = threading.local()
            self._phase = None
            self.trace_id = 0

    def reset(self) -> None:
        """Drop buffered spans but keep the enabled state and trace id."""
        with self._lock:
            self._spans.clear()
            self._pending.clear()
            self._root_durs.clear()
            self.dropped = 0
            self.kept = 0
            self.discarded = 0
            self._tls = threading.local()

    def set_phase(self, phase: Optional[str]) -> None:
        """Tag subsequently recorded spans with ``attrs["phase"] = phase``."""
        self._phase = phase

    # -- recording ---------------------------------------------------------

    def span(self, name: str, tier: str = "-", **attrs: Any) -> Any:
        """Open a timed span context; returns a shared no-op when disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, tier, attrs)

    def device_span(self, name: str, device: Any, tier: str = "-",
                    **attrs: Any) -> Any:
        """``span`` that also times its body on ``device``'s current stream
        with a pair of CUDA events (on the CPU, none): the host never waits
        on them here, ``snapshot`` resolves them into ``attrs["device_s"]``.
        A shared no-op when disabled."""
        if not self.enabled:
            return _NULL
        return _DeviceSpan(self, name, tier, attrs, device)

    def count(self, key: str, n: float = 1) -> None:
        """Add ``n`` to counter ``key`` of the innermost open span on this
        thread; a no-op when disabled."""
        if not self.enabled:
            return
        sp = getattr(self._tls, "open", None)
        if sp is not None:
            sp.counts[key] = sp.counts.get(key, 0) + n

    def count_later(self, key: str, value: Any) -> None:
        """Add ``value`` to counter ``key`` of the innermost open span once
        the device has filled it: ``value`` is a one-element host tensor
        that a copy behind the device's work fills without the host
        waiting.  It rolls up with the span's counters, not into its
        ``attrs``, until ``settle``; a no-op when disabled."""
        if not self.enabled:
            return
        sp = getattr(self._tls, "open", None)
        if sp is not None:
            sp.later.append((key, value))

    def settle(self) -> None:
        """Add the deferred counts (``count_later``) that reached the
        innermost open span to its counters.  Call it only where the host
        has already waited for the device past their copies, as after a
        readback: it reads host memory and waits for nothing."""
        sp = getattr(self._tls, "open", None)
        if sp is None:
            return
        for key, value in sp.later:
            sp.counts[key] = sp.counts.get(key, 0) + value.numpy().item()
        sp.later.clear()

    def wait(self, site: str) -> Any:
        """A context around a point where the host waits for the device
        (a readback, a blocking upload, a synchronize): counts one
        ``host_syncs`` and its host seconds in ``sync_wait_s`` (and under
        ``.<site>``).  A shared no-op when disabled."""
        if not self.enabled:
            return _NULL
        return _Wait(self, site)

    def event(self, name: str, tier: str = "-", **attrs: Any) -> None:
        """Record a zero-duration event parented to the current span."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        self._record(name, tier, t0, 0.0, next(self._ids), self._current_id(), attrs)

    def add(self, name: str, tier: str, t0: float, dur: float, **attrs: Any) -> None:
        """Record an externally-timed span parented to the current span."""
        if not self.enabled:
            return
        self._record(name, tier, t0, dur, next(self._ids), self._current_id(), attrs)

    def add_span(
        self,
        name: str,
        tier: str,
        t0: float,
        dur: float,
        *,
        parent_id: int = 0,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Record a span with an explicit parent (e.g. harvested server spans)."""
        if not self.enabled:
            return 0
        sid = next(self._ids)
        # explicit-parent spans (harvested from a server, stitched after
        # the fact) bypass tail staging: their root may have closed long
        # ago on another node, so they enter the ring directly
        self._record(name, tier, t0, dur, sid, parent_id, dict(attrs or {}),
                     stack=False)
        return sid

    def _current_id(self) -> int:
        """Return the innermost open span id on this thread (0 if none)."""
        return getattr(self._tls, "span_id", 0)

    def current(self) -> tuple:
        """Return ``(trace_id, current_span_id)`` for wire propagation."""
        return (self.trace_id, self._current_id())

    def _tid(self) -> int:
        """Map the OS thread ident to a small stable integer for exporters."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(
        self,
        name: str,
        tier: str,
        t0: float,
        dur: float,
        span_id: int,
        parent_id: int,
        attrs: Dict[str, Any],
        stack: bool = True,
    ) -> None:
        """Route one finished span: straight into the ring, or — under
        tail sampling, for stack-parented spans — through per-thread
        staging until its root trace is promoted or discarded."""
        if self._phase is not None and "phase" not in attrs:
            attrs["phase"] = self._phase
        rec = {
            "name": name,
            "tier": tier,
            "t0": t0,
            "dur": dur,
            "id": span_id,
            "parent": parent_id,
            "trace": self.trace_id,
            "tid": self._tid(),
            "attrs": attrs,
        }
        if not self.tail or not stack:
            self._append(rec)
            return
        if parent_id != 0:
            stage = getattr(self._tls, "stage", None)
            if stage is None:
                stage = self._tls.stage = []
            stage.append(rec)
            return
        # a root closed: decide the whole trace at once
        why = self._tail_decide(dur, attrs)
        staged = getattr(self._tls, "stage", None) or []
        self._tls.stage = []
        if why is None:
            self.discarded += 1
            return
        self.kept += 1
        attrs["why_kept"] = why
        for s in staged:
            self._append(s)
        self._append(rec)

    def _append(self, rec: Dict[str, Any]) -> None:
        """Append one span dict to the ring, counting overflow drops."""
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(rec)

    def _tail_decide(self, dur: float, attrs: Dict[str, Any]) -> Optional[str]:
        """Keep/drop verdict for one closed root trace.

        Effective latency is ``attrs["model_s"]`` when present (modeled
        seconds — deterministic under simulated transports and WR
        injection) and the wall ``dur`` otherwise.  Returns the
        ``why_kept`` reason or None to discard.
        """
        eff = float(attrs.get("model_s", dur))
        why = None
        if attrs.get("keep"):
            why = "marked"
        elif attrs.get("error") or attrs.get("failover"):
            why = "error"
        else:
            durs = sorted(self._root_durs)
            if len(durs) < 8:
                why = "warmup"     # no stable threshold yet: keep
            else:
                k = min(len(durs) - 1,
                        int(self.tail_quantile * len(durs)))
                if eff >= durs[k] and eff > 0.0:
                    why = "latency"
        self._root_durs.append(eff)
        return why

    def health(self) -> Dict[str, Any]:
        """Tracer health gauges: ring occupancy/drops + tail counters."""
        durs = sorted(self._root_durs)
        thr = 0.0
        if len(durs) >= 8:
            thr = durs[min(len(durs) - 1,
                           int(self.tail_quantile * len(durs)))]
        return {"enabled": int(self.enabled), "tail": int(self.tail),
                "capacity": self.capacity, "occupancy": len(self._spans),
                "dropped": self.dropped, "kept": self.kept,
                "discarded": self.discarded, "threshold_s": thr}

    # -- inspection / export ----------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Return a stable copy of the buffered spans (oldest first).  Each
        device span whose end event the device has passed gets its
        ``device_s``; the rest stay pending: this never waits for the
        device."""
        self._resolve(wait=False)
        with self._lock:
            return list(self._spans)

    def _resolve(self, wait: bool) -> None:
        """Write ``device_s`` into the device spans whose events the device
        has passed, oldest first; with ``wait``, wait for every one."""
        while True:
            with self._lock:
                if not self._pending or not (wait or self._pending[0][2].query()):
                    break
                attrs, start, end = self._pending.popleft()
            end.synchronize()
            attrs["device_s"] = start.elapsed_time(end) / 1e3

    def find(self, span_id: int) -> Optional[Dict[str, Any]]:
        """Return the most recent buffered span with *span_id*, if any."""
        if not span_id:
            return None
        with self._lock:
            for s in reversed(self._spans):
                if s["id"] == span_id:
                    return s
        return None

    def save(self, path: str) -> int:
        """Write the buffer as Chrome-trace JSON to *path*; returns span
        count.  Waits for the device to resolve every ``device_s``."""
        self._resolve(wait=True)
        spans = self.snapshot()
        blob = chrome_trace(spans)
        blob["otherData"] = {"clock_offset_ns": self.clock_offset_ns}
        with open(path, "w") as f:
            json.dump(blob, f)
        return len(spans)


def wall_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the closest of a
    few paired reads (the pair with the smallest gap wins)."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


#: Process-global tracer used by every instrumented tier.
TRACER = Tracer()


def chrome_trace(spans: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert raw spans to the Chrome trace-event ("Perfetto") format.

    Each span becomes a complete event (``ph="X"``) with microsecond
    ``ts``/``dur``; the raw span/parent ids and attrs ride along in
    ``args`` so :mod:`repro.obs.report` can rebuild the tree losslessly.
    """
    events = []
    for s in spans:
        args = {k: v for k, v in s["attrs"].items()}
        args["id"] = s["id"]
        args["parent"] = s["parent"]
        args["trace"] = s["trace"]
        events.append(
            {
                "name": s["name"],
                "cat": s["tier"],
                "ph": "X",
                "ts": s["t0"] * 1e6,
                "dur": max(s["dur"], 0.0) * 1e6,
                "pid": 0,
                "tid": s.get("tid", 0),
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Load a Chrome-trace JSON file back into raw span dicts."""
    with open(path) as f:
        blob = json.load(f)
    events = blob["traceEvents"] if isinstance(blob, dict) else blob
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        spans.append(
            {
                "name": ev["name"],
                "tier": ev.get("cat", "-"),
                "t0": ev.get("ts", 0.0) / 1e6,
                "dur": ev.get("dur", 0.0) / 1e6,
                "id": args.pop("id", 0),
                "parent": args.pop("parent", 0),
                "trace": args.pop("trace", 0),
                "tid": ev.get("tid", 0),
                "attrs": args,
            }
        )
    return spans

"""Mergeable log-bucketed latency histograms + the straggler detector.

Median-only metrics cannot explain tail latency under disaggregation:
one replica answering its doorbell batches 10x slower moves a fleet's
p99 while every mean stays flat.  This module is the per-(verb, shard)
tail visibility layer:

* :class:`LatencyHistogram` — one log-bucketed series (fixed geometric
  bucket bounds, ~3 per decade from 100 ns to 10 s).  Recording is an
  O(log buckets) bisect; histograms merge by bucket-wise addition, so
  per-child series roll up into a fleet view losslessly.  Quantiles are
  bucket-upper-bound estimates: monotone, deterministic, and identical
  on every machine for the same recorded values.
* :class:`VerbShardHist` — a dict of histograms keyed ``(verb, shard)``.
  Pools record into it from the ``MemoryPool._charge`` hook (modeled
  transport seconds, injection included) and the RDMA completion-poll
  path (measured wire seconds on remote transports); ``ShardedPool``
  merges its children's series into the fleet view its snapshot and the
  Prometheus exporter render.
* :class:`StragglerDetector` — flags a shard whose per-verb tail
  quantile diverges from the fleet median.  The verdict feeds
  ``ShardedPool`` replica-read ranking (flagged shards are penalized by
  their observed excess seconds-per-read, so reads route to a healthy
  replica) and the ``stats()["stragglers"]`` report.

Everything here is pure Python over plain numbers — no numpy, no jax —
so the jax-free ``PoolServer`` data plane can record into it too.
"""
from __future__ import annotations

from bisect import bisect_left
from statistics import median
from typing import Dict, Iterable, List, Optional, Tuple

#: Geometric bucket upper bounds (seconds), ~3 per decade, 100 ns .. 10 s.
#: Shared by every latency histogram so any two series merge bucket-wise.
HIST_BOUNDS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 3.0), 12) for e in range(-21, 4))


class LatencyHistogram:
    """One mergeable log-bucketed latency series.

    ``counts`` has ``len(HIST_BOUNDS) + 1`` slots (the last is the
    overflow bucket); ``sum_s``/``count`` make the series renderable as
    a Prometheus histogram and let merged views keep exact means.
    """

    __slots__ = ("counts", "sum_s", "count")

    def __init__(self):
        """Start empty: all buckets zero."""
        self.counts: List[int] = [0] * (len(HIST_BOUNDS) + 1)
        self.sum_s = 0.0
        self.count = 0

    def record(self, seconds: float) -> None:
        """Record one observation (negative values clamp to zero)."""
        s = max(float(seconds), 0.0)
        self.counts[bisect_left(HIST_BOUNDS, s)] += 1
        self.sum_s += s
        self.count += 1

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add *other*'s buckets into this series (bucket-wise; exact)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum_s += other.sum_s
        self.count += other.count
        return self

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the *q* quantile (seconds).

        Deterministic and monotone in *q*; the overflow bucket reports
        one log-step past the last bound.  Returns 0.0 when empty.
        """
        if self.count <= 0:
            return 0.0
        target = max(min(float(q), 1.0), 0.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                if i < len(HIST_BOUNDS):
                    return HIST_BOUNDS[i]
                return HIST_BOUNDS[-1] * (10.0 ** (1.0 / 3.0))
        return HIST_BOUNDS[-1] * (10.0 ** (1.0 / 3.0))

    def mean(self) -> float:
        """Exact mean of the recorded values (0.0 when empty)."""
        return self.sum_s / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        """JSON-ready form: bucket counts + exact sum/count."""
        return {"counts": list(self.counts), "sum_s": self.sum_s,
                "count": self.count}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        """Rebuild a series from :meth:`to_dict` output."""
        h = cls()
        counts = list(d.get("counts", ()))
        for i in range(min(len(counts), len(h.counts))):
            h.counts[i] = int(counts[i])
        h.sum_s = float(d.get("sum_s", 0.0))
        h.count = int(d.get("count", 0))
        return h


class VerbShardHist:
    """Latency histograms keyed by ``(verb, shard)``.

    The recording surface for the ``MemoryPool._charge`` hook and the
    completion-poll path; mergeable across children so ``ShardedPool``
    can roll its fleet into one view.
    """

    def __init__(self):
        """Start with no series; they appear on first record."""
        self._h: Dict[Tuple[str, int], LatencyHistogram] = {}

    def __len__(self) -> int:
        """Number of (verb, shard) series held."""
        return len(self._h)

    def record(self, verb: str, shard: int, seconds: float) -> None:
        """Record one observation under ``(verb, shard)``."""
        key = (verb, int(shard))
        h = self._h.get(key)
        if h is None:
            h = self._h[key] = LatencyHistogram()
        h.record(seconds)

    def get(self, verb: str, shard: int) -> Optional[LatencyHistogram]:
        """The series for ``(verb, shard)``, or None if never recorded."""
        return self._h.get((verb, int(shard)))

    def items(self) -> Iterable[Tuple[Tuple[str, int], LatencyHistogram]]:
        """Iterate ``((verb, shard), histogram)`` pairs (sorted keys)."""
        return iter(sorted(self._h.items()))

    def verbs(self) -> List[str]:
        """Distinct verbs with at least one recorded series."""
        return sorted({v for v, _ in self._h})

    def shards(self) -> List[int]:
        """Distinct shards with at least one recorded series."""
        return sorted({s for _, s in self._h})

    def merge(self, other: "VerbShardHist") -> "VerbShardHist":
        """Fold *other*'s series into this view (bucket-wise; exact)."""
        for key, h in other._h.items():
            mine = self._h.get(key)
            if mine is None:
                mine = self._h[key] = LatencyHistogram()
            mine.merge(h)
        return self

    def to_dict(self) -> dict:
        """JSON-ready nested form ``{verb: {str(shard): series}}``."""
        out: Dict[str, dict] = {}
        for (verb, shard), h in sorted(self._h.items()):
            out.setdefault(verb, {})[str(shard)] = h.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "VerbShardHist":
        """Rebuild a keyed view from :meth:`to_dict` output."""
        vh = cls()
        for verb, by_shard in d.items():
            for shard, series in by_shard.items():
                vh._h[(verb, int(shard))] = LatencyHistogram.from_dict(series)
        return vh


class StragglerDetector:
    """Flag shards whose per-verb tail diverges from the fleet.

    For every verb with enough samples on at least two shards, the
    detector estimates each shard's tail quantile and compares it to the
    fleet *median* of those estimates (the median is robust: one
    straggler cannot drag its own baseline up).  A shard is flagged when
    its tail exceeds ``ratio`` times the fleet median AND the absolute
    excess clears ``min_excess_s`` (so all-zero in-process fleets never
    flag on noise).  Verdicts are pure functions of the histogram
    counts — deterministic, no wall clock.
    """

    def __init__(self, *, quantile: float = 0.99, ratio: float = 4.0,
                 min_count: int = 32, min_excess_s: float = 1e-6):
        """Thresholds: tail *quantile* compared at ``ratio`` x fleet
        median, requiring ``min_count`` samples per shard series and an
        absolute excess of ``min_excess_s`` seconds."""
        self.quantile = float(quantile)
        self.ratio = float(ratio)
        self.min_count = int(min_count)
        self.min_excess_s = float(min_excess_s)

    def verdicts(self, hist: VerbShardHist) -> dict:
        """Evaluate one histogram view -> the straggler report.

        Returns ``{"flagged": {shard: {verb, shard_q_s, fleet_q_s,
        excess_s, ratio}}, "quantile": q, "ratio": r}``; when a shard
        diverges on several verbs the worst (largest excess) wins.
        """
        flagged: Dict[int, dict] = {}
        for verb in hist.verbs():
            qs = {}
            for shard in hist.shards():
                h = hist.get(verb, shard)
                if h is not None and h.count >= self.min_count:
                    qs[shard] = h.quantile(self.quantile)
            if len(qs) < 2:
                continue
            fleet = median(qs.values())
            for shard, q in qs.items():
                excess = q - fleet
                if (q > self.ratio * max(fleet, 1e-12)
                        and excess >= self.min_excess_s):
                    prev = flagged.get(shard)
                    if prev is None or excess > prev["excess_s"]:
                        flagged[shard] = {
                            "verb": verb, "shard_q_s": q,
                            "fleet_q_s": fleet, "excess_s": excess,
                            "ratio": q / max(fleet, 1e-12)}
        return {"flagged": flagged, "quantile": self.quantile,
                "ratio": self.ratio}

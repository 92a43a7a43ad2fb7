"""The percentile the benchmark reports."""
from __future__ import annotations

import math


def weighted_percentile(values, weights, q: float) -> float:
    """The q-th percentile (0-100) over a population in which
    ``values[i]`` occurs ``weights[i]`` times, interpolated linearly
    between closest ranks (numpy's default): a latency taken over every
    query when a batch's queries share its wall time."""
    pairs = sorted((v, int(w)) for v, w in zip(values, weights) if w > 0)
    total = sum(w for _, w in pairs)
    if not total:
        raise ValueError("percentile of no values")
    pos = (total - 1) * q / 100.0
    lo = math.floor(pos)

    def at(rank: int) -> float:          # the value at a 0-based rank
        seen = 0
        for v, w in pairs:
            seen += w
            if rank < seen:
                return v
        return pairs[-1][0]
    a, b = at(lo), at(min(lo + 1, total - 1))
    return a + (b - a) * (pos - lo)


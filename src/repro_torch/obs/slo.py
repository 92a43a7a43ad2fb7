"""Latency SLOs with multi-window burn-rate evaluation.

An :class:`SLO` is a target quantile plus a latency threshold —
"p99 < 5ms" means "at least 99% of requests finish under 5 ms", which
leaves an *error budget* of 1% of requests allowed over the threshold.
The :class:`SLOTracker` evaluates SLOs per (tier, key) over rolling
request-counted windows and reports the SRE-standard *burn rate*:

    burn = observed violation rate / error budget

burn == 1 means the budget is being consumed exactly as provisioned;
burn > 1 means the tail is degrading faster than the SLO tolerates (a
straggling replica, a degraded bearer); burn < 1 is healthy headroom.
Two windows are kept — a short one that reacts within a few requests
and a long one that smooths it — mirroring the multi-window burn-rate
alerting pattern: page when BOTH burn, so a single slow request can't
page but a sustained regression can't hide.

Windows are counted in *requests*, not seconds, so a test or benchmark
feeding deterministic modeled latencies gets deterministic burn rates —
no wall clock anywhere.  ``SearchServer.stats()["slo"]`` and
``metrics_text`` surface the report; ``examples/online_serving.py
--slo "p99<5ms"`` prints it as a table.
"""
from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Union

_SPEC = re.compile(
    r"^\s*p(?P<q>\d+(?:\.\d+)?)\s*<\s*(?P<v>\d+(?:\.\d+)?)\s*"
    r"(?P<u>us|ms|s)\s*$", re.IGNORECASE)

_UNIT_S = {"us": 1e-6, "ms": 1e-3, "s": 1.0}


@dataclass(frozen=True)
class SLO:
    """One latency objective: ``quantile`` of requests under
    ``threshold_s`` seconds.  ``budget`` is the tolerated violation
    fraction (``1 - quantile``)."""

    quantile: float
    threshold_s: float
    name: str = ""

    @property
    def budget(self) -> float:
        """Error budget: the fraction of requests allowed to violate."""
        return max(1.0 - self.quantile, 1e-9)


def parse_slo(spec: Union[str, SLO]) -> SLO:
    """Parse ``"p99<5ms"`` (units: us / ms / s) into an :class:`SLO`."""
    if isinstance(spec, SLO):
        return spec
    m = _SPEC.match(str(spec))
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r} (want e.g. 'p99<5ms', 'p95<250us')")
    q = float(m.group("q")) / 100.0
    if not 0.0 < q < 1.0:
        raise ValueError(f"SLO quantile must be in (0, 100): {spec!r}")
    thr = float(m.group("v")) * _UNIT_S[m.group("u").lower()]
    return SLO(quantile=q, threshold_s=thr, name=str(spec).strip())


class SLOTracker:
    """Rolling per-(tier, key) SLO evaluation with two burn windows.

    ``slos`` configures what to watch: a single spec (string or
    :class:`SLO`) applies to tier ``"serve"`` (end-to-end request
    latency), or a ``{tier: spec}`` dict attaches an objective per tier
    (``"serve"`` / ``"fetch"`` / ``"queue"`` — whatever the caller
    records).  ``record`` is a no-op for unconfigured tiers, so the
    serve tier can feed every stage unconditionally.  ``key`` is the
    within-tier series — the serve tier passes the tenant.
    """

    def __init__(self, slos, *, short_window: int = 64,
                 long_window: int = 512):
        """Normalize ``slos`` (see class docstring) and size the rolling
        request-counted windows."""
        if isinstance(slos, (str, SLO)):
            slos = {"serve": slos}
        self.slos: Dict[str, SLO] = {t: parse_slo(s)
                                     for t, s in dict(slos).items()}
        self.short_window = int(short_window)
        self.long_window = int(long_window)
        # (tier, key) -> (short deque, long deque) of 0/1 violations
        self._win: Dict[tuple, tuple] = {}
        self._n: Dict[tuple, int] = {}
        self._viol: Dict[tuple, int] = {}

    def record(self, tier: str, key: str, latency_s: float) -> None:
        """Score one request latency against the tier's SLO (if any)."""
        slo = self.slos.get(tier)
        if slo is None:
            return
        k = (tier, str(key))
        win = self._win.get(k)
        if win is None:
            win = self._win[k] = (deque(maxlen=self.short_window),
                                  deque(maxlen=self.long_window))
            self._n[k] = 0
            self._viol[k] = 0
        bad = 1 if float(latency_s) > slo.threshold_s else 0
        win[0].append(bad)
        win[1].append(bad)
        self._n[k] += 1
        self._viol[k] += bad

    @staticmethod
    def _burn(win: deque, budget: float) -> float:
        """Burn rate over one window (0.0 while the window is empty)."""
        if not win:
            return 0.0
        return (sum(win) / len(win)) / budget

    def report(self) -> dict:
        """Attainment + burn rates per (tier, key), JSON-ready.

        ``burn`` is the min of the short- and long-window burns (the
        multi-window AND: both must burn to alert); ``met`` is whether
        lifetime attainment meets the objective.
        """
        out: Dict[str, dict] = {}
        for (tier, key), (short, long_) in sorted(self._win.items()):
            slo = self.slos[tier]
            n = self._n[(tier, key)]
            viol = self._viol[(tier, key)]
            attain = (n - viol) / n if n else 1.0
            bs = self._burn(short, slo.budget)
            bl = self._burn(long_, slo.budget)
            out.setdefault(tier, {})[key] = {
                "slo": slo.name or f"p{slo.quantile * 100:g}"
                       f"<{slo.threshold_s * 1e3:g}ms",
                "quantile": slo.quantile,
                "threshold_ms": slo.threshold_s * 1e3,
                "n": n, "violations": viol,
                "attainment": attain,
                "met": attain >= slo.quantile,
                "burn_short": bs, "burn_long": bl,
                "burn": min(bs, bl),
            }
        return out

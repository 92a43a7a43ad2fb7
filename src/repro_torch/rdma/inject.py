"""Deterministic WR-level latency/error injection for straggler chaos.

A :class:`WRInjector` attaches to a bearer (``bearer.injector = inj``)
and is consulted by :meth:`QueuePair.post_send` for every posted WR
list, *before* the list is framed or submitted.  Schedules are pure
functions of ``(post index, seed)`` — a multiplicative-hash hit rule,
no RNG state, no wall clock — so a chaos run is reproducible bit for
bit and its assertions can be exact.

Three degradation shapes compose:

* ``delay_s`` — fixed per-post delay (a uniformly slow NIC/link);
* ``spike_s`` every ``spike_every`` posts — tail spikes (GC pause,
  congestion burst) that move p99 while leaving p50 alone;
* ``error_every`` — the selected posts raise :class:`InjectedFault`
  *instead of* posting, modeling a flushed QP send.  The fault fires
  before any submit/accounting, so a failed post charges nothing.

Injected delay accumulates in ``injected_s``; transports that model
time (``SimulatedRDMAPool``) read the delta around their post loop and
fold it into the *observed* clock (``sim_s``, histograms) — never into
the a-priori cost model — so the straggler detector, not a cheating
cost model, is what routes reads away from the degraded shard.
"""
from __future__ import annotations

import time

#: Knuth's multiplicative hash constant; spreads post indices uniformly.
_MIX = 2654435761


class InjectedFault(ConnectionError):
    """A WR post failed by injection (models a flushed QP send)."""


class WRInjector:
    """Seeded per-post latency/error schedule for one bearer.

    Parameters
    ----------
    seed:
        Mixes into the hit rule; two injectors with different seeds
        degrade different posts.
    delay_s:
        Fixed delay added to every post.
    spike_s, spike_every:
        Extra delay added when ``hit(i, spike_every)``; 0 disables.
    error_every:
        Posts where ``hit(i, error_every)`` raise
        :class:`InjectedFault` before submit; 0 disables.
    sleep:
        When True, injected delay also really sleeps (wall-clock
        chaos); default False keeps runs fast and deterministic.
    """

    def __init__(self, *, seed: int = 0, delay_s: float = 0.0,
                 spike_s: float = 0.0, spike_every: int = 0,
                 error_every: int = 0, sleep: bool = False):
        """Capture the schedule; counters start at zero."""
        self.seed = int(seed)
        self.delay_s = float(delay_s)
        self.spike_s = float(spike_s)
        self.spike_every = int(spike_every)
        self.error_every = int(error_every)
        self.sleep = bool(sleep)
        self.posts = 0
        self.injections = 0
        self.injected_s = 0.0
        self.faults = 0

    def hit(self, i: int, every: int) -> bool:
        """Deterministic hit rule: does post *i* land on an *every* slot."""
        if every <= 0:
            return False
        return (i * _MIX + self.seed) % every == 0

    def on_post(self, wrs) -> None:
        """Consulted once per posted WR list, before framing/submit.

        Raises :class:`InjectedFault` on error hits; otherwise adds the
        scheduled delay to ``injected_s`` (and optionally sleeps).
        """
        i = self.posts
        self.posts += 1
        if self.hit(i, self.error_every):
            self.faults += 1
            raise InjectedFault(
                f"injected WR fault at post {i} (seed={self.seed})")
        dt = self.delay_s
        if self.hit(i, self.spike_every):
            dt += self.spike_s
        if dt > 0.0:
            self.injections += 1
            self.injected_s += dt
            if self.sleep:
                time.sleep(dt)

    def snapshot(self) -> dict:
        """Counters + schedule parameters, JSON-ready."""
        return {"seed": self.seed, "posts": self.posts,
                "injections": self.injections,
                "injected_s": self.injected_s, "faults": self.faults,
                "delay_s": self.delay_s, "spike_s": self.spike_s,
                "spike_every": self.spike_every,
                "error_every": self.error_every}

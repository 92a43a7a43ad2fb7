"""Background compaction: fold overflow back into the layout off-path.

Appends land in a group's shared overflow strip; searches then pay an
extra overflow read per touched group until someone calls ``repack``.
The serve path deliberately never does (PR 3 moved repack off the hot
path) — the :class:`Compactor` is the *someone*: it watches per-group
overflow occupancy straight from the pool's ``meta_table`` mirror,
picks the worst offenders, and issues ``repack`` verbs under a rate
budget so compaction cost never bursts into serving latency.

The trigger is event-driven, not poll-only: the pool's mutation hook
(``MemoryPool.register_mutation_hook``) marks groups dirty as appends
happen, so a ``tick`` inspects only groups that actually changed.
``tick()`` is synchronous (tests drive it deterministically);
``start()`` runs the same tick on a daemon thread for real deployments.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set

import numpy as np

from repro_torch.core.layout import MT_OV_A, MT_OV_B
from repro_torch.obs.trace import TRACER


@dataclass
class CompactionPolicy:
    """Knobs for when and how fast the daemon compacts.

    ``threshold`` is the overflow-strip occupancy (used / ov_cap) above
    which a group is eligible; ``max_repacks_per_tick`` is the rate
    budget; ``interval_s`` paces the background thread.
    """

    threshold: float = 0.5
    max_repacks_per_tick: int = 2
    interval_s: float = 0.25


class Compactor:
    """Watch overflow ratios and repack the worst groups off-path.

    ``data_lookup(gids) -> vectors`` resolves global ids to raw vectors
    during repack (the engine wires its own ``_lookup``);
    ``on_compacted(group)`` lets the owner invalidate caches for the
    rewritten group.
    """

    def __init__(self, pool, data_lookup: Callable,
                 policy: Optional[CompactionPolicy] = None,
                 on_compacted: Optional[Callable[[int], None]] = None):
        self.pool = pool
        self.data_lookup = data_lookup
        self.policy = policy or CompactionPolicy()
        self.on_compacted = on_compacted
        self.dirty: Set[int] = set()
        self.groups_compacted = 0
        self.ticks = 0
        self.skipped_budget = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._scanned_once = False
        pool.register_mutation_hook(self._on_mutation)

    # ------------------------------------------------------------ events

    def _on_mutation(self, verb: str, **info) -> None:
        if verb == "append" and "group" in info:
            self.dirty.add(int(info["group"]))

    # ------------------------------------------------------------ policy

    def overflow_ratios(self) -> Dict[int, float]:
        """Per-group overflow occupancy (used / ov_cap) from meta."""
        spec = self.pool.store.spec
        mt = np.asarray(self.pool.read_meta())
        out: Dict[int, float] = {}
        for g in range(spec.n_groups):
            row = mt[2 * g]
            used = int(row[MT_OV_A]) + int(row[MT_OV_B])
            out[g] = used / max(spec.ov_cap, 1)
        return out

    def _candidates(self) -> Dict[int, float]:
        ratios = self.overflow_ratios()
        if self._scanned_once:
            ratios = {g: r for g, r in ratios.items() if g in self.dirty}
        self._scanned_once = True
        return {g: r for g, r in ratios.items()
                if r >= self.policy.threshold}

    # ------------------------------------------------------------ ticking

    def tick(self) -> int:
        """One compaction round: repack up to the budget, worst-first.

        Returns how many groups were repacked.  Deterministic — the
        tests call this directly instead of racing the thread.
        """
        self.ticks += 1
        cands = sorted(self._candidates().items(),
                       key=lambda kv: -kv[1])
        if len(cands) > self.policy.max_repacks_per_tick:
            self.skipped_budget += (len(cands)
                                    - self.policy.max_repacks_per_tick)
            cands = cands[:self.policy.max_repacks_per_tick]
        done = 0
        for group, ratio in cands:
            t0 = time.perf_counter()
            changed = self.pool.repack(group, self.data_lookup)
            if TRACER.enabled:
                TRACER.add("ingest.compact", "ingest", t0,
                           time.perf_counter() - t0, group=int(group),
                           ratio=float(ratio), changed=bool(changed))
            self.dirty.discard(group)
            if changed:
                done += 1
                self.groups_compacted += 1
                if self.on_compacted is not None:
                    self.on_compacted(group)
        return done

    # ------------------------------------------------------------ daemon

    def start(self) -> "Compactor":
        """Run ticks on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.policy.interval_s):
                self.tick()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="repro-compactor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the background thread (idempotent)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Counters for the Prometheus exporter."""
        return {
            "ticks": self.ticks,
            "groups_compacted": self.groups_compacted,
            "skipped_budget": self.skipped_budget,
            "dirty_groups": len(self.dirty),
        }

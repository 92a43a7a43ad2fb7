"""Query-aware batched data loading — paper §3.3.

Given a batch of queries and each query's top-*b* partitions (from the
cached meta-HNSW), plan the fetches so that:

  * each required partition is loaded from the memory pool **at most
    once** per batch (the paper's headline invariant);
  * partitions already resident in the compute-node cache are not
    fetched at all;
  * fetches are grouped into *doorbell batches* of <= ``doorbell`` spans
    per round trip;
  * the number of simultaneously-resident partitions never exceeds the
    cache capacity *c*; processing is organized in **rounds**: fetch a
    set, serve every (query, partition) pair that hits it, evict LRU,
    repeat.  Per-query running top-k accumulates across rounds
    (Fig. 5's "temporarily stored for further comparison").

Planning is plain host code (numpy): it is the compute-instance CPU role
in the paper, and it only touches the (B, b) partition-id matrix the
meta-route already produced.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def pow2_pad(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floor ``lo``) — the shape-bucketing rule
    shared by the engine's round padding and the serve tier's fused-batch
    padding, so jitted stages see a bounded set of shapes."""
    m = lo
    while m < n:
        m *= 2
    return m


def doorbell_chunks(items, doorbell: int):
    """Split ``items`` into doorbell batches of <= ``doorbell`` entries —
    the one grouping rule shared by the planner (span fetches) and the
    memory-pool transports (descriptor submission), so verb accounting
    and the round schedule can never disagree on what one round trip
    carries."""
    doorbell = max(int(doorbell), 1)
    return [items[j:j + doorbell] for j in range(0, len(items), doorbell)]


def doorbell_chunks_sharded(items, doorbell: int, owner_of=None):
    """Destination-aware doorbell batching: descriptors are grouped by
    owning shard FIRST (``owner_of(item) -> shard``), then each
    destination's run is doorbell-chunked — one round trip never mixes
    destinations, because a doorbell rings ONE remote NIC.  With
    ``owner_of=None`` (single memory node) this is ``doorbell_chunks``.
    """
    if owner_of is None:
        return doorbell_chunks(items, doorbell)
    by: dict[int, list] = {}
    for it in np.asarray(items).reshape(-1):
        by.setdefault(int(owner_of(int(it))), []).append(it)
    out = []
    for s in sorted(by):
        out.extend(doorbell_chunks(np.asarray(by[s], np.int64), doorbell))
    return out


@dataclass
class Round:
    """One fetch-and-serve round.  Slot ids are assigned at *planning*
    time (a later round may evict this round's partitions, so executors
    must not re-derive slots from the final cache state)."""

    fetch_pids: np.ndarray          # partitions to pull this round (<= free slots)
    fetch_slots: np.ndarray         # cache slot for each fetched partition
    doorbells: list[np.ndarray]     # fetch_pids split into doorbell batches
    evict_pids: np.ndarray          # evicted before the fetch (LRU)
    serve_pairs: np.ndarray         # (n, 2) [query_idx, pid] served this round
    pair_slots: np.ndarray          # (n,) slot holding each pair's partition
    pair_ranks: np.ndarray = None   # (n,) occurrence index of the pair's
                                    # query within this round (0-based) —
                                    # the merge "lane" the pair lands in

    @property
    def n_lanes(self) -> int:
        """Merge lanes this round needs: max pairs any one query has."""
        if self.pair_ranks is None or not len(self.pair_ranks):
            return 1
        return int(self.pair_ranks.max()) + 1

    def serve_tensors(self, pad_to: int, n_queries: int):
        """Batch-major device feed for this round's serve pairs, padded
        to ``pad_to`` lanes: ``(qi, pids, slots, ranks, valid)``.

        Padding rows target the scatter dump row ``n_queries`` (one past
        the real batch) so a fixed-shape ``(B+1, n_lanes, k)`` scatter can
        drop them without a gather/where pass; pid/slot/rank padding is 0
        and masked by ``valid``.
        """
        n = len(self.serve_pairs)
        qi = np.full(pad_to, n_queries, np.int32)
        pids = np.zeros(pad_to, np.int32)
        slots = np.zeros(pad_to, np.int32)
        ranks = np.zeros(pad_to, np.int32)
        if n:
            qi[:n] = self.serve_pairs[:, 0]
            pids[:n] = self.serve_pairs[:, 1]
            slots[:n] = self.pair_slots
            ranks[:n] = self.pair_ranks
        valid = np.arange(pad_to) < n
        return qi, pids, slots, ranks, valid


@dataclass
class Plan:
    rounds: list[Round]
    unique_pids: np.ndarray         # all distinct partitions this batch needs
    n_cache_hits: int               # (query, partition) pairs already resident
    n_fetches: int                  # partitions actually transferred

    def loads_per_partition(self) -> dict[int, int]:
        cnt: dict[int, int] = {}
        for r in self.rounds:
            for p in r.fetch_pids.tolist():
                cnt[p] = cnt.get(p, 0) + 1
        return cnt


class LRUCacheState:
    """Host-side mirror of the compute-node resident-partition cache.

    Slot contents live on device (``engine.py``); this tracks pid->slot
    and recency.  Functionally updated by the plan executor so the most
    recently used *c* partitions persist into the next batch (§3.3)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slots: list[int] = [-1] * capacity   # slot -> pid
        self._recency: list[int] = []             # pids, LRU first

    def resident(self) -> set[int]:
        return {p for p in self.slots if p >= 0}

    def slot_of(self, pid: int) -> int:
        return self.slots.index(pid)

    def touch(self, pid: int) -> None:
        if pid in self._recency:
            self._recency.remove(pid)
        self._recency.append(pid)

    def admit(self, pid: int) -> tuple[int, int]:
        """Returns (slot, evicted_pid or -1)."""
        if pid in self.slots:
            self.touch(pid)
            return self.slots.index(pid), -1
        if -1 in self.slots:
            slot = self.slots.index(-1)
            evicted = -1
        else:
            lru = self._recency.pop(0)
            slot = self.slots.index(lru)
            evicted = lru
        self.slots[slot] = pid
        self.touch(pid)
        return slot, evicted

    def drop(self, pid: int) -> None:
        """Invalidate ``pid`` if resident (stale after an insert)."""
        if pid in self.slots:
            self.slots[self.slots.index(pid)] = -1
        if pid in self._recency:
            self._recency.remove(pid)


class TieredCacheState:
    """Two-tier compute-node cache for the quantized search path.

    * ``quant`` — the LARGE tier: int8 spans + codebook blocks.  Stage-1
      planning runs ``plan_batch`` against it, so a quantized hit avoids
      the remote read entirely (the §3.3 invariant, at ~1/4 the bytes
      per miss).
    * ``exact`` — the SMALL tier: full-precision spans.  Stage-2 re-rank
      rows that land in an exact-resident partition cost zero wire
      bytes; everything else is fetched row-granular.

    Admission to the exact tier is cost-based: ``note_rerank_miss``
    accumulates each partition's missed re-rank rows and
    ``should_admit`` fires once the cumulative missed bytes exceed one
    full span fetch — i.e. only partitions whose re-rank traffic has
    already paid for a span get promoted (a decayed counter, so cold
    partitions age out instead of eventually all qualifying).
    """

    DECAY = 0.5          # eviction decay on the miss counter

    def __init__(self, quant_cap: int, exact_cap: int):
        self.quant = LRUCacheState(max(int(quant_cap), 1))
        self.exact = LRUCacheState(max(int(exact_cap), 1))
        self._miss_rows: dict[int, float] = {}   # pid -> missed rerank rows

    def invalidate(self, pid: int) -> None:
        self.quant.drop(pid)
        self.exact.drop(pid)
        self._miss_rows.pop(pid, None)

    def note_rerank_miss(self, pid: int, n_rows: int) -> None:
        self._miss_rows[pid] = self._miss_rows.get(pid, 0.0) + n_rows

    def should_admit(self, pid: int, row_bytes: int, span_bytes: int) -> bool:
        return (pid not in self.exact.resident()
                and self._miss_rows.get(pid, 0.0) * row_bytes >= span_bytes)

    def admit_exact(self, pid: int) -> tuple[int, int]:
        """Promote ``pid`` (caller fetches + installs the exact span).
        Returns (slot, evicted_pid or -1); the evictee's miss counter is
        decayed, not erased — re-promotion needs fresh traffic."""
        slot, evicted = self.exact.admit(pid)
        self._miss_rows[pid] = 0.0
        if evicted >= 0:
            self._miss_rows[evicted] = (
                self._miss_rows.get(evicted, 0.0) * self.DECAY)
        return slot, evicted


def _pair_ranks(pairs: np.ndarray) -> np.ndarray:
    """Occurrence index of each pair's query within its round (0-based).

    A query served against m partitions in one round occupies merge lanes
    0..m-1; the device merge scatters lane-major and tops-k once."""
    counts: dict[int, int] = {}
    ranks = np.zeros(len(pairs), np.int64)
    for j, (q, _) in enumerate(pairs):
        r = counts.get(int(q), 0)
        ranks[j] = r
        counts[int(q)] = r + 1
    return ranks


def plan_batch(topb_pids: np.ndarray, cache: LRUCacheState, *,
               doorbell: int = 8, owner_of=None) -> Plan:
    """Build the round schedule for one query batch.

    ``topb_pids``: (B, b) int — per-query required partitions, nearest
    first.  Mutates ``cache`` recency/slots to its post-batch state.
    ``owner_of`` (pid -> shard), when given, makes each round's
    advertised doorbell batches destination-aware (a sharded pool splits
    its descriptor submission the same way).
    """
    topb = np.asarray(topb_pids)
    B, b = topb.shape
    cap = cache.capacity

    # (query, pid) demand pairs, de-duplicated per query
    demand: dict[int, list[int]] = {}
    for q in range(B):
        for p in dict.fromkeys(int(x) for x in topb[q]):
            demand.setdefault(p, []).append(q)
    unique = np.array(sorted(demand), dtype=np.int64)

    resident = cache.resident()
    hits = [p for p in unique.tolist() if p in resident]
    n_cache_hits = sum(len(demand[p]) for p in hits)
    missing = [p for p in unique.tolist() if p not in resident]
    # fetch order: highest fan-in first — serves the most queries per
    # round and makes early rounds maximally useful
    missing.sort(key=lambda p: -len(demand[p]))

    rounds: list[Round] = []
    # round 0: serve everything already resident (zero fetches)
    if hits:
        pairs = np.array([(q, p) for p in hits for q in demand[p]], np.int64)
        slots = np.array([cache.slot_of(p) for p in hits], np.int64)
        pslots = np.array([cache.slot_of(p) for p in hits
                           for _ in demand[p]], np.int64)
        for p in hits:
            cache.touch(p)
        rounds.append(Round(np.array([], np.int64), np.array([], np.int64),
                            [], np.array([], np.int64), pairs, pslots,
                            _pair_ranks(pairs)))

    i = 0
    while i < len(missing):
        take = missing[i:i + cap]
        i += len(take)
        evicted, slots = [], []
        for p in take:
            slot, ev = cache.admit(p)
            slots.append(slot)
            if ev >= 0:
                evicted.append(ev)
        pairs = np.array([(q, p) for p in take for q in demand[p]], np.int64)
        pslots = np.array([s for p, s in zip(take, slots)
                           for _ in demand[p]], np.int64)
        fetch = np.array(take, np.int64)
        doorbells = doorbell_chunks_sharded(fetch, doorbell, owner_of)
        rounds.append(Round(fetch, np.array(slots, np.int64), doorbells,
                            np.array(evicted, np.int64), pairs, pslots,
                            _pair_ranks(pairs)))

    return Plan(rounds=rounds, unique_pids=unique,
                n_cache_hits=n_cache_hits, n_fetches=len(missing))


def naive_plan(topb_pids: np.ndarray) -> list[tuple[int, int]]:
    """The Naive d-HNSW baseline: every (query, partition) need is its own
    RDMA read — no dedup, no cache, no doorbell.  Returns the raw fetch
    list [(query, pid), ...] whose length is the round-trip count."""
    topb = np.asarray(topb_pids)
    out = []
    for q in range(topb.shape[0]):
        for p in dict.fromkeys(int(x) for x in topb[q]):
            out.append((q, p))
    return out

"""ShardedPool — the region split (and replicated) across N memory nodes.

Port of ``repro/pool/sharded.py``.  The parent stages its meta table on
``device``, and ``make_pool_factory`` builds every child on that same
device (a ``RemotePool`` child uploads what it reads there).  The
host-side state (placement, replicas, liveness, heat counters, the
failover and migration tallies) is the reference's numpy code unchanged,
so those fields equal the reference's.  The span merge
fills one device buffer per output with ``index_copy_``; the row fan-out
selects each owner's lanes with ``torch.where``.

One memory node cannot hold a production-scale region, and §3.3's
doorbell batching only pays off at scale when descriptor batches are
formed *per destination node*.  ``ShardedPool`` implements the full
``MemoryPool`` protocol over N child pools (any mix of ``LocalPool`` /
``SimulatedRDMAPool`` / ``RemotePool``, including heterogeneous fabrics
per shard to model stragglers):

* **Group-granular placement** — the unit of ownership is the layout
  *group* (two partner sub-HNSWs + their shared overflow, §3.2), so a
  fetch span never straddles shards and every doorbell descriptor names
  blocks on exactly one node.  A pluggable ``PlacementPolicy``
  (``pool/placement.py``) owns the group -> shard map; the
  frequency-aware policy migrates hot groups toward the fastest /
  least-loaded shard at runtime (``refresh_blocks`` re-stages the
  arriving group on the destination node; results are bit-identical
  before and after a migration).
* **Replication** (``replication=R``) — every group is placed on R
  distinct shards under optional per-shard byte budgets
  (``placement.apply_budgets`` / ``place_replicated``).  Reads are
  served by the fastest / least-loaded live replica of each group
  (recomputed whenever liveness or placement changes); committed writes
  (``append`` / ``repack``) fan out to the remaining replicas as
  block-granular ``refresh_blocks`` re-stages, accounted under
  ``replication_io`` — background traffic, never charged to a request
  ledger, so ledger parity with a single pool is preserved exactly.
* **Failover** — a child raising ``PoolUnavailableError`` is marked
  dead: in-flight reads transparently retry on a surviving replica,
  and every group the dead shard held is *re-replicated* from the host
  region (the source of truth) onto the best surviving shard with room.
  With ``replication=1`` there is nothing to fail over to and the error
  surfaces, exactly as before.
* **Elastic scale** — ``add_shard`` stages the region on a new child
  and moves only the groups the placement policy would newly put there
  (incremental rebalance); ``remove_shard`` drains a node through the
  same re-replication path as a failure, minus the failure.
* **Per-shard doorbell fan-out** — ``read_spans`` / ``read_rows`` /
  ``read_quant_rows`` / ``post_*`` split each descriptor batch by
  serving shard and charge each slice on that shard's own fabric; the
  caller's ledger sees summed bytes/descriptors and ``trips = max``
  over shards when ``parallel=True`` (nodes answer their batches
  concurrently — the critical path is the slowest slice) or the sum in
  serial mode.  With one shard this reduces exactly to the child's own
  accounting.
* **Write routing** — ``append``/``repack`` execute once on the
  primary live replica, which keeps its device twin (and the quantized
  mirror / flat-quant row index) coherent; the shared host region stays
  the single source of truth, so a rebuild (``adopt``), migration,
  replica fan-out, or post-failure re-replication can always re-stage
  any node from it.

1/N staging: the children share the serialized host region (this
container has one address space), but each capable child compacts its
*device* copy to just the groups it holds replicas of
(``LocalPool.restrict_staging`` — block-compacted, with a region-block
-> staged-slot indirection), so per-shard device bytes scale ~1/N with
the fleet.  Migration, replica fan-out, and failover healing re-stage
only the moved blocks (an arriving group is adopted onto the compacted
tail at group granularity); children without the hook (``RemotePool``
— the server already holds only bytes it was sent) are left alone.
What the model measures — per-destination verb counts, wire bytes, and
modeled time — is exactly what a multi-node deployment would see over
real transports.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layout as LA
from repro_torch.core.cost_model import NetLedger
from repro_torch.core.layout import Store
from repro_torch.pool.placement import (PlacementPolicy, _shard_rank,
                                  apply_budgets, make_placement,
                                  place_replicated)
from repro_torch.pool.protocol import (MemoryPool, PoolUnavailableError,
                                 _fresh_totals)
from repro_torch.pool.sim_rdma import fanout_dt


class ShardedPool(MemoryPool):
    """The region split group-granularly across N child pools.

    Reads fan out per destination shard (doorbell batches formed per
    node); a ``PlacementPolicy`` owns the group -> shard map and may
    migrate hot groups at runtime.  With ``replication >= 2`` every
    group lives on R distinct shards (``placement.place_replicated``):
    reads are served from the fastest/least-loaded live replica,
    committed writes fan to the others via ``refresh_blocks``, and a
    ``PoolUnavailableError`` from a child marks the shard dead, retries
    the read on a survivor, and re-replicates the dead shard's groups
    from the host region.  Request ledgers are charged once regardless
    of R — replication/failover/elastic traffic is accounted in its own
    counters (``replication_io``/``failover``/``elastic``), never on
    the query wire, so ledger parity with a single-node pool holds.
    """

    kind = "sharded"

    def __init__(self, store: Store,
                 child_factories: Sequence[Callable[[Store], MemoryPool]],
                 *, device, placement="round_robin", parallel: bool = True,
                 replication: int = 1,
                 shard_budgets: Optional[Sequence[float]] = None,
                 straggler: Optional[dict] = None,
                 straggler_check_every: int = 0):
        assert len(child_factories) >= 1, "need at least one shard"
        self.store = store
        self.device = torch.device(device)
        self.children = [f(store) for f in child_factories]
        for s, c in enumerate(self.children):
            c.shard_id = s        # keys the per-(verb, shard) histograms
        self.placement: PlacementPolicy = make_placement(placement)
        self.parallel = parallel
        self.replication = max(1, int(replication))
        self.shard_budgets = (None if shard_budgets is None
                              else [float(b) for b in shard_budgets])
        self.verbs: Counter = Counter()
        self.totals = _fresh_totals()
        self.sim_s: dict[str, float] = {}
        self.migration = {"n": 0, "bytes": 0.0, "sim_s": 0.0}
        # background replica fan-out of committed writes (not request-
        # charged, like migration)
        self.replication_io = {"fanout_writes": 0, "bytes": 0.0,
                               "sim_s": 0.0}
        # failure handling: deaths seen, read batches that had to retry
        # on a survivor, the healing copies that followed, and shards
        # that rejoined from their own durable state (recover_shard)
        self.failover = {"deaths": 0, "read_retries": 0,
                         "rereplicated_groups": 0,
                         "rereplicate_bytes": 0.0, "lost_groups": 0,
                         "recovered_shards": 0, "recovered_groups": 0}
        # groups each dead shard held at death, for recover_shard
        self._dead_held: dict[int, list[int]] = {}
        # planned fleet changes (add_shard / remove_shard)
        self.elastic = {"added": 0, "removed": 0, "moved_groups": 0,
                        "bytes": 0.0}
        # tail-divergence detection over the children's per-(verb, shard)
        # latency histograms; a flagged shard's serving cost is penalized
        # by its observed tail excess so replica reads route around it
        from repro_torch.obs.hist import StragglerDetector
        self.straggler = StragglerDetector(**(straggler or {}))
        self._check_every = max(0, int(straggler_check_every))
        self._since_check = 0
        self._straggler_penalty: dict[int, float] = {}
        self._last_straggler_report: Optional[dict] = None
        self.straggler_stats = {"checks": 0, "flagged_now": 0,
                                "reroutes": 0, "moved_groups": 0}
        # dead children skipped during a trace drain (satellite: a dying
        # PoolServer must never poison the query path via observability)
        self.trace_harvest_failures = 0
        self._alive = np.ones(len(self.children), bool)
        self._reset_placement()
        self._stage_meta()

    # ------------------------------------------------------------ ownership

    @property
    def n_shards(self) -> int:
        """Fleet size, dead shards included (indices stay stable)."""
        return len(self.children)

    def owner_of_group(self, group: int) -> int:
        """Shard currently *serving* the group's reads (its fastest /
        least-loaded live replica; the only replica when R=1)."""
        return int(self._serve[group])

    def owner_of_pid(self, pid: int) -> int:
        """Destination shard of one partition's fetch span (a partition
        is served where its group is served) — also the shard-aware
        doorbell key the round scheduler groups descriptors by."""
        return int(self._serve[int(pid) // 2])

    def replicas_of_group(self, group: int) -> list[int]:
        """All shards holding the group (live or not; -1 = unfilled)."""
        return [int(s) for s in self._replicas[group]]

    def _owners_of_pids(self, pids) -> np.ndarray:
        return self._serve[np.asarray(pids, np.int64) // 2]

    def _owners_of_rows(self, rows) -> np.ndarray:
        """Serving shard per region row address (-1 rows -> -1)."""
        rows = np.asarray(rows, np.int64)
        grp = (rows // self.spec.slot_vecs) // self.spec.group_blocks
        own = self._serve[np.clip(grp, 0, len(self._serve) - 1)]
        return np.where(rows >= 0, own, -1)

    def _live_replicas(self, group: int) -> list[int]:
        """Live replicas of one group, primary first; raises when the
        group has lost every copy (nothing left to serve or write)."""
        reps = [int(s) for s in self._replicas[group]
                if s >= 0 and self._alive[s]]
        if not reps:
            raise PoolUnavailableError(
                f"group {group} has no live replica (replication="
                f"{self._replicas.shape[1]}, alive="
                f"{int(self._alive.sum())}/{self.n_shards})")
        return reps

    def _require_live(self, owners: np.ndarray, pids: np.ndarray) -> None:
        if (owners < 0).any():
            lost = sorted({int(p) // 2 for p in pids[owners < 0]})
            raise PoolUnavailableError(
                f"groups {lost} have no live replica "
                f"(alive={int(self._alive.sum())}/{self.n_shards})")

    def _group_rows(self) -> np.ndarray:
        """Live rows per group (base + overflow) — the size signal for
        size-balanced placement."""
        spec, mt = self.spec, self.store.meta_table
        rows = np.zeros(spec.n_groups, np.int64)
        for pid in range(spec.n_partitions):
            rows[pid // 2] += int(self.store.n_base[pid])
        first = 2 * np.arange(spec.n_groups)
        rows += mt[first, LA.MT_OV_A].astype(np.int64)
        rows += mt[first, LA.MT_OV_B].astype(np.int64)
        return rows

    def _shard_costs(self) -> list[float]:
        """Modeled seconds per span read, per shard (0 = in-process) —
        the speed signal for replica selection and hot-group migration."""
        pb = float(self.spec.partition_bytes())
        return [c.model_dt(pb, 1.0, 1.0) if hasattr(c, "model_dt") else 0.0
                for c in self.children]

    def _block_copy_bytes(self, n_blocks: int) -> float:
        """Host -> node bytes of re-staging ``n_blocks`` region blocks
        (graph + vectors, plus the quantized mirror when attached) —
        the unit of migration / replication / failover accounting."""
        spec = self.spec
        nb = float(n_blocks * spec.block_bytes())
        if self.store.qvec_buf is not None:
            nb += float(n_blocks * (spec.vblk + spec.n_qgroups * 4))
        return nb

    def _group_footprint_bytes(self) -> float:
        """Serialized bytes of one group — the capacity unit per-shard
        byte budgets are enforced in (groups are fixed-size regions)."""
        return self._block_copy_bytes(self.spec.group_blocks)

    def _reset_placement(self) -> None:
        costs = self._shard_costs()
        owner = np.asarray(
            self.placement.place(self.spec.n_groups, self.n_shards,
                                 group_sizes=self._group_rows(),
                                 shard_costs=costs), np.int64)
        sizes_b = np.full(self.spec.n_groups,
                          self._group_footprint_bytes())
        if self.shard_budgets is not None:
            owner = apply_budgets(owner, group_sizes=sizes_b,
                                  shard_budgets=self.shard_budgets,
                                  shard_costs=costs)
        self._replicas = place_replicated(
            owner, self.n_shards, self.replication,
            group_sizes=sizes_b, shard_budgets=self.shard_budgets,
            shard_costs=costs)
        if not self._alive.all():
            dead = np.nonzero(~self._alive)[0]
            self._replicas[np.isin(self._replicas, dead)] = -1
        self._recompute_serving()
        self._apply_staging()

    def _apply_staging(self, only: Optional[int] = None) -> None:
        """Compact each capable child's device region to the groups it
        holds replicas of (1/N staging).  A full placement (re)build is
        the only time this runs — incremental placement changes go
        through ``refresh_blocks``, which adopts an arriving group onto
        the compacted tail without re-staging anything else.  Children
        without the hook (remote transports) keep their own staging."""
        for s, c in enumerate(self.children):
            if only is not None and s != only:
                continue
            if not self._alive[s] or not hasattr(c, "restrict_staging"):
                continue
            held = [g for g in range(len(self._replicas))
                    if (self._replicas[g] == s).any()]
            c.restrict_staging(held)

    def _recompute_serving(self) -> None:
        """Re-pick each group's serving replica: cheapest (modeled
        seconds per span) live replica, with accumulated serving load
        breaking cost ties so equal-speed replicas split the groups.
        Shards the straggler detector flagged carry their observed tail
        excess as a cost penalty, so reads prefer a healthy replica."""
        costs = np.asarray(self._shard_costs(), np.float64)
        for s, p in getattr(self, "_straggler_penalty", {}).items():
            if 0 <= s < len(costs):
                costs[s] += p
        loads = np.zeros(self.n_shards, np.float64)
        serve = np.full(len(self._replicas), -1, np.int64)
        for g in range(len(self._replicas)):
            best = -1
            for s in self._replicas[g]:
                s = int(s)
                if s < 0 or not self._alive[s]:
                    continue
                if (best < 0 or (costs[s], loads[s], s)
                        < (costs[best], loads[best], best)):
                    best = s
            if best >= 0:
                serve[g] = best
                loads[best] += 1.0
        self._serve = serve

    # ------------------------------------------------------------ charging

    def _child_sim(self, child) -> float:
        return getattr(child, "sim_total_s", 0.0)

    def _scratch(self, shard: int, ledger: NetLedger) -> NetLedger:
        """Per-destination ledger slice, priced on that shard's own
        fabric (falling back to the caller's for in-process children)."""
        fabric = getattr(self.children[shard], "fabric", ledger.fabric)
        return NetLedger(fabric)

    def _charged_call(self, shard: int, ledger: NetLedger, fn):
        """Run one child verb under a scratch ledger; returns the verb
        result and its charge slice (bytes, descriptors, trips, sim_dt)
        — the single place the per-destination bookkeeping lives."""
        child = self.children[shard]
        scratch = self._scratch(shard, ledger)
        t0 = self._child_sim(child)
        res = fn(child, scratch)
        return res, (scratch.bytes, scratch.descriptors,
                     scratch.round_trips, self._child_sim(child) - t0)

    def _charge_fanout(self, verb: str, ledger: Optional[NetLedger],
                       slices: list[tuple]) -> None:
        """Fold per-shard slices [(bytes, descriptors, trips, sim_dt)]
        into the caller's ledger and the pool totals: bytes and
        descriptors sum; trips (and modeled time) reduce by max when the
        shards answer in parallel, by sum in serial mode."""
        if ledger is None or not slices:
            return
        nb = float(sum(s[0] for s in slices))
        nd = float(sum(s[1] for s in slices))
        trips = fanout_dt([s[2] for s in slices], self.parallel)
        dt = fanout_dt([s[3] for s in slices], self.parallel)
        ledger.round_trips += trips
        ledger.descriptors += nd
        ledger.bytes += nb
        ledger.events += 1
        self.totals["round_trips"] += trips
        self.totals["descriptors"] += nd
        self.totals["bytes"] += nb
        if dt:
            self.sim_s[verb] = self.sim_s.get(verb, 0.0) + dt

    # ------------------------------------------------------------ meta

    def _stage_meta(self) -> None:
        self._mt_dev = torch.as_tensor(self.store.meta_table,
                                       device=self.device)
        self._mt_dirty = False

    # read_meta: the shared MemoryPool implementation (serves the
    # parent's own cached table — children are never consulted)

    def adopt(self, store: Store) -> None:
        """See ``MemoryPool.adopt``; re-registers every live child and
        rebuilds placement (a child dying here is only marked dead —
        the fresh placement already excludes it)."""
        self.store = store
        for s, c in enumerate(self.children):
            if not self._alive[s]:
                continue
            try:
                c.adopt(store)
            except PoolUnavailableError:
                # placement is rebuilt below, so no re-replication here
                self._alive[s] = False
                self.failover["deaths"] += 1
        self._reset_placement()
        self._stage_meta()

    def attach_quant(self, group: int) -> None:
        """See ``MemoryPool.attach_quant``; attaches the mirror once on
        the shared host store, then every live child stages it."""
        LA.attach_quant_mirror(self.store, group)
        self._stage_quant()

    def _stage_quant(self) -> None:
        """Stage the already-attached host mirror on every live child
        (same split as ``LocalPool._stage_quant``: attach once, stage
        everywhere — used when the loader built the mirror host-side)."""
        for s, c in enumerate(self.children):
            if not self._alive[s]:
                continue
            try:
                c._stage_quant()
            except PoolUnavailableError:
                self._on_shard_down(s)

    # ------------------------------------------------------------ reads

    def read_spans(self, pids, *, ledger: Optional[NetLedger],
                   doorbell: int = 1, quant: bool = False,
                   quant_graph: bool = True):
        """See ``MemoryPool.read_spans``; descriptors are batched per
        serving shard (each batch charges its own slice), and a failed
        slice retries on a surviving replica — the failed attempt
        charges nothing, so the total equals the single-node charge."""
        pids = np.asarray(pids).reshape(-1)
        verb = "read_spans_quant" if quant else "read_spans"
        self.verbs[verb] += len(pids)
        if self._check_every and ledger is not None:
            self._since_check += 1
            if self._since_check >= self._check_every:
                self._since_check = 0
                self.check_stragglers()
        m = len(pids)
        parts, slices = [], []
        todo = np.arange(m, dtype=np.int64)
        while len(todo):
            owners = self._owners_of_pids(pids[todo])
            self._require_live(owners, pids[todo])
            retry = []
            for s in np.unique(owners):
                s = int(s)
                idx = todo[owners == s]
                sub = pids[idx]
                try:
                    if ledger is None:
                        res = self.children[s].read_spans(
                            sub, ledger=None, doorbell=doorbell,
                            quant=quant, quant_graph=quant_graph)
                        sl = None
                    else:
                        res, sl = self._charged_call(
                            s, ledger,
                            lambda c, l: c.read_spans(sub, ledger=l,
                                                      doorbell=doorbell,
                                                      quant=quant,
                                                      quant_graph=quant_graph))
                except PoolUnavailableError:
                    # failed slice charged nothing (transports charge
                    # after the wire answers): mark the shard dead, heal,
                    # and re-issue these spans on a surviving replica
                    self._on_shard_down(s)
                    retry.append(idx)
                    continue
                if sl is not None:
                    slices.append(sl)
                parts.append((idx, res))
            if retry:
                self.failover["read_retries"] += 1
                todo = np.concatenate(retry)
            else:
                todo = todo[:0]
        self._charge_fanout(verb, ledger, slices)
        outs = None
        for idx, res in parts:
            if outs is None:
                outs = [torch.zeros((m,) + tuple(r.shape[1:]), dtype=r.dtype,
                                    device=self.device) for r in res]
            di = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
            for o, r in zip(outs, res):
                o.index_copy_(0, di, r)
        if ledger is not None:        # heat accrues on charged traffic
            self._note_span_access(pids)
        return tuple(outs)

    def _masked_fanout(self, rows, gather):
        """Row-granular fan-out: each shard gathers the full tensor with
        non-owned lanes masked to -1, and the owner's lanes are selected
        back — dead (-1) lanes keep gather-row-0 placeholders exactly
        like a single pool, masked by the caller.  A shard failing
        mid-fan marks it dead and restarts the fan on the healed
        serving map (child gathers are side-effect-free)."""
        rows_h = (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
                  else np.asarray(rows))
        while True:
            owners = self._owners_of_rows(rows_h)
            if ((owners < 0) & (np.asarray(rows_h, np.int64) >= 0)).any():
                raise PoolUnavailableError(
                    f"row read names groups with no live replica (alive="
                    f"{int(self._alive.sum())}/{self.n_shards})")
            out, failed = None, False
            for s in np.unique(owners[owners >= 0]):
                s = int(s)
                mask = owners == s
                sub = torch.as_tensor(
                    np.where(mask, rows_h, -1).astype(np.int32),
                    device=self.device)
                try:
                    res = gather(self.children[s], sub)
                except PoolUnavailableError:
                    self._on_shard_down(s)
                    failed = True
                    break
                if not isinstance(res, tuple):
                    res = (res,)
                mdev = torch.as_tensor(mask, device=self.device)
                if out is None:
                    out = list(res)
                else:
                    out = [torch.where(
                        mdev.reshape(mdev.shape + (1,) * (r.ndim - mdev.ndim)),
                        r, o) for o, r in zip(out, res)]
            if failed:
                self.failover["read_retries"] += 1
                continue
            if out is None:           # every lane dead: any child serves
                live = np.nonzero(self._alive)[0]
                s = int(live[0]) if len(live) else 0
                return gather(self.children[s], torch.as_tensor(
                    np.asarray(rows_h, np.int64).astype(np.int32),
                    device=self.device))
            return out[0] if len(out) == 1 else tuple(out)

    def read_rows(self, rows):
        """See ``MemoryPool.read_rows``; fanned by row ownership with
        transparent replica failover."""
        self.verbs["read_rows"] += 1
        return self._masked_fanout(rows, lambda c, r: c.read_rows(r))

    def read_quant_rows(self, rows):
        """See ``MemoryPool.read_quant_rows``; fanned like ``read_rows``."""
        self.verbs["read_quant_rows"] += 1
        return self._masked_fanout(rows,
                                   lambda c, r: c.read_quant_rows(r))

    # ------------------------------------------------- accounting posts

    def post_span_reads(self, n: int, *, ledger: NetLedger,
                        doorbell: int = 1, quant: bool = False,
                        quant_graph: bool = True, pids=None) -> None:
        """See ``MemoryPool.post_span_reads``; with ``pids`` each
        charge is attributed to the span's serving shard."""
        if pids is None:
            # no destination info: price on the caller's fabric, like a
            # single-node pool (callers that know the spans pass pids)
            return super().post_span_reads(n, ledger=ledger,
                                           doorbell=doorbell, quant=quant,
                                           quant_graph=quant_graph)
        self.verbs["post_span_reads"] += n
        pids = np.asarray(pids).reshape(-1)
        owners = self._owners_of_pids(pids)
        slices = []
        for s in range(self.n_shards):
            k = int((owners == s).sum())
            if not k:
                continue
            _, sl = self._charged_call(
                s, ledger,
                lambda c, l: c.post_span_reads(k, ledger=l,
                                               doorbell=doorbell,
                                               quant=quant,
                                               quant_graph=quant_graph))
            slices.append(sl)
        self._charge_fanout("post_span_reads", ledger, slices)
        self._note_span_access(pids)

    def post_row_reads(self, groups, *, ledger: NetLedger,
                       doorbell: int = 1) -> None:
        """See ``MemoryPool.post_row_reads``; groups are charged on
        their owning shard's slice."""
        groups = list(groups)
        self.verbs["post_row_reads"] += len(groups)
        by: dict[int, list] = {}
        for pid, cnt in groups:
            s = self.owner_of_pid(pid) if pid >= 0 else 0
            by.setdefault(max(s, 0), []).append((pid, cnt))
        slices = []
        for s, sub in sorted(by.items()):
            _, sl = self._charged_call(
                s, ledger,
                lambda c, l: c.post_row_reads(sub, ledger=l,
                                              doorbell=doorbell))
            slices.append(sl)
        self._charge_fanout("post_row_reads", ledger, slices)

    # ------------------------------------------------------------ writes

    def append(self, vec, gid: int, pid: int, *,
               ledger: Optional[NetLedger]) -> int:
        """See ``MemoryPool.append``; executes on the primary live
        replica (children share the host store, so exactly one may run
        the insert), charges the write once, then syncs the touched
        blocks to the other replicas via ``refresh_blocks`` (accounted
        in ``replication_io``, not on the request ledger).  A primary
        that dies mid-call is checked for commit via the overflow
        counters before retrying on a survivor."""
        spec = self.spec
        pid_i, gid_i = int(pid), int(gid)
        group = pid_i // 2
        side = int(self.store.meta_table[pid_i, LA.MT_SIDE])
        col = LA.MT_OV_A if side == 0 else LA.MT_OV_B
        slot, sl = -1, None
        while True:
            primary = self._live_replicas(group)[0]
            pre = int(self.store.meta_table[pid_i, col])
            try:
                if ledger is None:
                    slot, sl = self.children[primary].append(
                        vec, gid_i, pid_i, ledger=None), None
                else:
                    slot, sl = self._charged_call(
                        primary, ledger,
                        lambda c, l: c.append(vec, gid_i, pid_i, ledger=l))
                break
            except PoolUnavailableError:
                self._on_shard_down(primary)
                cnt = int(self.store.meta_table[pid_i, col])
                if cnt != pre:
                    # the deterministic insert committed to the host
                    # region (the source of truth) before the wire died:
                    # the write exists, the dead node no longer matters,
                    # and healing already re-staged it onto a survivor.
                    # Charge the caller exactly once, like LocalPool.
                    slot = cnt - 1 if side == 0 else spec.ov_cap - cnt
                    sl = None
                    if ledger is not None:
                        wire = spec.dim * 4 + 8
                        if self.store.qvec_buf is not None:
                            wire += (spec.dim
                                     + (spec.dim // spec.quant_group) * 4)
                        ledger.write(wire, descriptors=1)
                        self.totals["round_trips"] += 1
                        self.totals["descriptors"] += 1
                        self.totals["bytes"] += wire
                    break
                # nothing landed anywhere: clean retry on a survivor
        if slot < 0:
            return slot
        self.verbs["append"] += 1
        self._mt_dirty = True
        if sl is not None:
            self._charge_fanout("append", ledger, [sl])
        lay_group = int(self.store.meta_table[pid_i, LA.MT_GROUP])
        co = LA.overflow_write_coords(spec, lay_group, slot)
        blocks = sorted({int(co["vec_block"]), int(co["gid_block"])})
        self._fan_write(group, blocks, exclude=primary)
        self._notify_mutation("append", group=lay_group, pid=pid_i,
                              slot=int(slot))
        return slot

    def repack(self, group: int, data_lookup) -> bool:
        """See ``MemoryPool.repack``; primary-replica execution with
        the same commit-detection/fan-out discipline as ``append``."""
        group = int(group)
        self.verbs["repack"] += 1
        mt, first = self.store.meta_table, 2 * group
        while True:
            primary = self._live_replicas(group)[0]
            pre = (int(mt[first, LA.MT_OV_A]), int(mt[first, LA.MT_OV_B]))
            try:
                ok = self.children[primary].repack(group, data_lookup)
                break
            except PoolUnavailableError:
                self._on_shard_down(primary)
                if (int(mt[first, LA.MT_OV_A]),
                        int(mt[first, LA.MT_OV_B])) != pre:
                    # the host-side re-pack committed before the block
                    # WRITE shipped; the host region is the source of
                    # truth and the dead node no longer needs the blocks
                    ok = True
                    break
                # host untouched: the re-pack is deterministic — retry
                # wholesale on a survivor
        if ok:
            self._mt_dirty = True
            spec = self.spec
            blocks = np.arange(group * spec.group_blocks,
                               (group + 1) * spec.group_blocks)
            self._fan_write(group, blocks, exclude=primary)
            self._notify_mutation("repack", group=group)
        return ok

    def _fan_write(self, group: int, block_ids, exclude: int) -> None:
        """Propagate a committed write to the group's other live
        replicas: re-stage the touched blocks from the host region (the
        write landed there first).  Background replication traffic —
        accounted in ``replication_io``, never charged to a request
        ledger, exactly like migration — so request-side ledger parity
        with a single pool holds at any R."""
        ids = np.asarray(sorted({int(b) for b in np.asarray(block_ids)
                                 .reshape(-1)}), np.int64)
        nb = self._block_copy_bytes(len(ids))
        for s in [int(x) for x in self._replicas[group]]:
            if s < 0 or s == exclude or not self._alive[s]:
                continue
            try:
                self.children[s].refresh_blocks(ids)
            except PoolUnavailableError:
                self._on_shard_down(s)
                continue
            child = self.children[s]
            dt = (child.model_dt(nb, 1.0, 1.0)
                  if hasattr(child, "model_dt") else 0.0)
            self.replication_io["fanout_writes"] += 1
            self.replication_io["bytes"] += nb
            self.replication_io["sim_s"] += dt
            if dt:
                self.sim_s["replicate"] = (self.sim_s.get("replicate", 0.0)
                                           + dt)

    # ------------------------------------------------------------ failover

    def _stage_group(self, shard: int, group: int) -> None:
        """Re-stage one whole group on ``shard`` from the host region."""
        spec = self.spec
        blocks = np.arange(group * spec.group_blocks,
                           (group + 1) * spec.group_blocks)
        self.children[shard].refresh_blocks(blocks)

    def _on_shard_down(self, shard: int, *, planned: bool = False) -> None:
        """Mark one shard dead and heal: every group replicated there
        gets a replacement replica re-staged from the host region onto
        the best surviving shard (cheapest, then least replica-loaded)
        that holds no copy of it; when no such shard exists the group
        keeps serving from its remaining replicas.  Planned removals
        (``remove_shard``) take the same path but count under
        ``elastic`` instead of ``failover``."""
        shard = int(shard)
        if shard < 0 or shard >= self.n_shards or not self._alive[shard]:
            return
        self._alive[shard] = False
        self._dead_held[shard] = [
            g for g in range(len(self._replicas))
            if (self._replicas[g] == shard).any()]
        if planned:
            self.elastic["removed"] += 1
        else:
            self.failover["deaths"] += 1
        if self._replicas.shape[1] < 2 and not planned:
            # replication=1 keeps the pre-replication contract: an
            # unplanned death is surfaced, not silently healed — the
            # dead shard's groups are lost and reads of them raise.
            # (A *planned* drain still heals: the host region has the
            # bytes and the operator asked for the move.)
            for row in self._replicas:
                if (row == shard).any():
                    row[row == shard] = -1
                    self.failover["lost_groups"] += 1
            self._recompute_serving()
            return
        costs = np.asarray(self._shard_costs(), np.float64)
        loads = np.zeros(self.n_shards, np.float64)
        for row in self._replicas:
            for s in row:
                if s >= 0 and self._alive[s]:
                    loads[int(s)] += 1.0
        fp = self._group_footprint_bytes()
        for g in range(len(self._replicas)):
            row = self._replicas[g]
            cols = np.nonzero(row == shard)[0]
            if not len(cols):
                continue
            placed = False
            while not placed:
                have = {int(s) for s in row if s >= 0 and self._alive[s]}
                cand = [int(s) for s in _shard_rank(costs, loads)
                        if self._alive[s] and int(s) not in have]
                if not cand:
                    break
                dst = cand[0]
                try:
                    self._stage_group(dst, g)
                except PoolUnavailableError:
                    self._on_shard_down(dst)
                    continue
                row[cols[0]] = dst
                loads[dst] += 1.0
                if planned:
                    self.elastic["moved_groups"] += 1
                    self.elastic["bytes"] += fp
                else:
                    self.failover["rereplicated_groups"] += 1
                    self.failover["rereplicate_bytes"] += fp
                child = self.children[dst]
                dt = (child.model_dt(fp, 1.0, 1.0)
                      if hasattr(child, "model_dt") else 0.0)
                if dt:
                    self.sim_s["failover"] = (
                        self.sim_s.get("failover", 0.0) + dt)
                placed = True
            if not placed:
                row[cols] = -1
                if not any(int(s) >= 0 and self._alive[int(s)]
                           for s in row):
                    self.failover["lost_groups"] += 1
            # a shard appears at most once per row, but scrub defensively
            row[row == shard] = -1
        self._recompute_serving()

    # ------------------------------------------------------------ elastic

    def add_shard(self, child_factory: Callable[[Store], MemoryPool]) -> int:
        """Scale the fleet out by one node at runtime.

        The new child stages the shared region (its factory does — same
        contract as construction time), then only the groups the
        placement policy would newly put on it migrate there
        (incremental rebalance, not a full reshuffle): each such group's
        *serving* replica moves to the new node; its other replicas stay
        put, so the replication factor is preserved.  Returns the new
        shard's index."""
        new = self.n_shards
        child = child_factory(self.store)
        child.shard_id = new
        if self.store.qvec_buf is not None:
            child._stage_quant()
        self.children.append(child)
        self._alive = np.append(self._alive, True)
        self.elastic["added"] += 1
        # start the new node empty-compacted: the groups the placement
        # moves below are adopted one by one (1/N staging from day one)
        self._apply_staging(only=new)
        desired = np.asarray(
            self.placement.place(self.spec.n_groups, self.n_shards,
                                 group_sizes=self._group_rows(),
                                 shard_costs=self._shard_costs()), np.int64)
        fp = self._group_footprint_bytes()
        for g in np.nonzero(desired == new)[0]:
            g = int(g)
            row = self._replicas[g]
            if (row == new).any():
                continue
            cur = int(self._serve[g])
            cols = np.nonzero(row == cur)[0] if cur >= 0 else np.zeros(0)
            col = int(cols[0]) if len(cols) else 0
            try:
                self._stage_group(new, g)
            except PoolUnavailableError:
                self._on_shard_down(new)
                break
            row[col] = new
            self.elastic["moved_groups"] += 1
            self.elastic["bytes"] += fp
        self._recompute_serving()
        return new

    def remove_shard(self, shard: int) -> None:
        """Planned drain of one node: its groups re-replicate onto
        survivors through the same path a failure takes (minus the
        failure), then the node leaves the serving set.  The child
        object stays in ``children`` so shard indices remain stable;
        any transport it holds is closed."""
        self._on_shard_down(int(shard), planned=True)
        child = self.children[int(shard)]
        if hasattr(child, "close"):
            child.close()

    def recover_shard(self, shard: int,
                      child_factory: Callable[[Store], MemoryPool]) -> None:
        """Rejoin a restarted memory node in place — the durable path.

        The new child recovered its region from its own data-dir (WAL
        replay), so unlike ``_on_shard_down`` healing NOTHING is
        re-staged from the host region: the factory connects (a durable
        ``RemotePool`` uses ``attach="auto"`` and skips the upload when
        the server's recovered fingerprint matches the mirror), the old
        transport is closed, and any group slots the death left empty
        are handed back to the recovered shard.  With ``replication=1``
        this is what turns a "lost" group back into a served one.
        """
        shard = int(shard)
        assert 0 <= shard < self.n_shards, shard
        old = self.children[shard]
        if hasattr(old, "close"):
            old.close()
        child = child_factory(self.store)
        child.shard_id = shard
        if (self.store.qvec_buf is not None
                and getattr(child, "attached_via", "upload") != "recovered"
                and hasattr(child, "_stage_quant")):
            child._stage_quant()     # full re-upload path needs the mirror
        self.children[shard] = child
        was_dead = not self._alive[shard]
        self._alive[shard] = True
        self.failover["recovered_shards"] += 1
        if was_dead:
            restored = 0
            for g in self._dead_held.pop(shard, []):
                row = self._replicas[g]
                if (row == shard).any():
                    continue
                free = np.nonzero(row < 0)[0]
                if not len(free):
                    continue          # fully re-replicated elsewhere
                if not any(int(s) >= 0 and self._alive[int(s)]
                           for s in row):
                    # the group had lost every copy — it is back now
                    self.failover["lost_groups"] = max(
                        0, self.failover["lost_groups"] - 1)
                row[free[0]] = shard
                restored += 1
            self.failover["recovered_groups"] += restored
        self._recompute_serving()
        self._apply_staging(only=shard)

    # ------------------------------------------------------------ migration

    def _note_span_access(self, pids) -> None:
        due = False
        for p in np.asarray(pids).reshape(-1):
            due = self.placement.note_access(int(p) // 2) or due
        if due:
            self._rebalance()

    def _rebalance(self) -> None:
        # group_sizes deliberately omitted: computing live rows walks
        # every partition on the host, and no migrating policy reads
        # them — this runs inside the span-read hot path
        if (self._serve < 0).any():
            return                    # degraded: heal first, then tune
        moves = self.placement.plan_moves(self._serve.copy(),
                                          shard_costs=self._shard_costs())
        for g, src, dst in moves:
            self._migrate(int(g), int(src), int(dst))

    def _migrate(self, group: int, src: int, dst: int) -> None:
        """Move one group's *serving replica* shard-to-shard: re-stage
        its blocks on the destination from the host region (source of
        truth), flip the serving entry, and account the background copy
        separately from verb traffic (it is not charged to any request
        ledger).  When the destination already holds a replica the
        migration is a pure serving switch — no bytes move."""
        spec = self.spec
        if src == dst or self._serve[group] != src:
            return
        if dst < 0 or dst >= self.n_shards or not self._alive[dst]:
            return
        row = self._replicas[group]
        if (row == dst).any():
            self._serve[group] = dst
            self.migration["n"] += 1
            return
        try:
            self._stage_group(dst, group)
        except PoolUnavailableError:
            self._on_shard_down(dst)
            return
        cols = np.nonzero(row == src)[0]
        row[int(cols[0]) if len(cols) else 0] = dst
        self._serve[group] = dst
        nb = self._block_copy_bytes(spec.group_blocks)
        dts = [c.model_dt(nb, 1.0, 1.0) if hasattr(c, "model_dt") else 0.0
               for c in (self.children[src], self.children[dst])]
        dt = fanout_dt(dts, True)   # src READ streams into the dst WRITE
        self.migration["n"] += 1
        self.migration["bytes"] += nb
        self.migration["sim_s"] += dt
        if dt:
            self.sim_s["migrate"] = self.sim_s.get("migrate", 0.0) + dt

    # ------------------------------------------------------------ stats

    def merged_hist(self):
        """Fleet-wide per-(verb, shard) latency view: every child's
        histogram (keyed by the ``shard_id`` set at construction) merged
        with the parent's own — the input the straggler detector reads."""
        from repro_torch.obs.hist import VerbShardHist
        m = VerbShardHist()
        own = getattr(self, "_hist", None)
        if own is not None:
            m.merge(own)
        for c in self.children:
            ch = getattr(c, "_hist", None)
            if ch is not None:
                m.merge(ch)
        return m

    def check_stragglers(self) -> dict:
        """Run the straggler detector over :meth:`merged_hist` and act.

        A flagged shard's serving cost is penalized by its observed tail
        excess (seconds at the detector's quantile), and the serving map
        is recomputed — with ``replication >= 2`` the flagged shard's
        groups move to a healthy replica (counted in
        ``straggler_stats``); a recovered shard loses its penalty the
        same way.  Runs automatically every ``straggler_check_every``
        charged span reads when configured, or manually.  Returns the
        detector report (also surfaced in ``snapshot()["stragglers"]``).
        """
        self.straggler_stats["checks"] += 1
        report = self.straggler.verdicts(self.merged_hist())
        penalty = {int(s): float(i["excess_s"])
                   for s, i in report["flagged"].items()}
        self.straggler_stats["flagged_now"] = len(penalty)
        if penalty != self._straggler_penalty:
            old = self._serve.copy()
            self._straggler_penalty = penalty
            self._recompute_serving()
            moved = int((old != self._serve).sum())
            if moved:
                self.straggler_stats["reroutes"] += 1
                self.straggler_stats["moved_groups"] += moved
        self._last_straggler_report = report
        return report

    def harvest_trace(self) -> int:
        """Drain server-side trace spans from every live remote child
        (children without the hook — local/sim shards — contribute 0).
        A child dying mid-harvest is skipped and counted
        (``trace_harvest_failures``): observability must never take down
        the pool it is observing."""
        n = 0
        for s, c in enumerate(self.children):
            if not self._alive[s] or not hasattr(c, "harvest_trace"):
                continue
            try:
                n += c.harvest_trace()
            except PoolUnavailableError:
                self.trace_harvest_failures += 1
                continue
        return n

    @property
    def sim_total_s(self) -> float:
        """Modeled wire seconds on the parent's critical path."""
        return sum(self.sim_s.values())

    def snapshot(self) -> dict:
        """See ``MemoryPool.snapshot``; adds placement/replication state,
        per-shard child snapshots (dead shards report ``kind: down``),
        and the migration/replication_io/failover/elastic counters."""
        out = super().snapshot()
        out["n_shards"] = self.n_shards
        out["parallel"] = self.parallel
        out["placement"] = self.placement.name
        out["replication"] = int(self._replicas.shape[1])
        out["alive"] = self._alive.tolist()
        serve = self._serve[self._serve >= 0]
        out["groups_by_shard"] = np.bincount(
            serve, minlength=self.n_shards).tolist()
        reps = self._replicas[self._replicas >= 0]
        out["replicas_by_shard"] = np.bincount(
            reps, minlength=self.n_shards).tolist()
        out["migration"] = dict(self.migration)
        out["replication_io"] = dict(self.replication_io)
        out["failover"] = dict(self.failover)
        out["elastic"] = dict(self.elastic)
        out["trace_harvest_failures"] = self.trace_harvest_failures
        rep = self._last_straggler_report or {}
        out["stragglers"] = dict(
            self.straggler_stats,
            flagged={str(s): dict(i)
                     for s, i in rep.get("flagged", {}).items()},
            penalty_s={str(s): p
                       for s, p in self._straggler_penalty.items()})
        mh = self.merged_hist()
        if len(mh):
            out["hist"] = mh.to_dict()
        shards = []
        for s, c in enumerate(self.children):
            try:
                shards.append(c.snapshot())
            except Exception:
                # a dead node must never break stats reporting
                shards.append({"kind": "down", "shard": s})
        out["shards"] = shards
        if self.sim_s or any("sim_total_s" in s for s in out["shards"]):
            out["sim_s"] = dict(self.sim_s)
            out["sim_total_s"] = self.sim_total_s
        stg = [s.get("staging") for s in out["shards"]]
        if any(stg):
            # per-node device staging: the 1/N footprint story in one place
            out["staging"] = {
                "device_bytes_by_shard": [(t or {}).get("device_bytes", 0)
                                          for t in stg],
                "blocks_staged_by_shard": [(t or {}).get("blocks_staged", 0)
                                           for t in stg],
                "restaged_blocks": sum((t or {}).get("restaged_blocks", 0)
                                       for t in stg)}
        wired = [s["wire"] for s in out["shards"] if "wire" in s]
        if wired:
            # remote children: measured wire traffic summed over nodes
            out["wire_total"] = {
                k: sum(w[k] for w in wired)
                for k in ("frames_tx", "frames_rx", "bytes_tx", "bytes_rx")}
        return out

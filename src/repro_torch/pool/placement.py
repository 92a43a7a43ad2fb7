"""Group-granular placement policies for the sharded memory pool.

The layout's unit of locality is the *group*: two partner sub-HNSWs
around one shared overflow region, serialized contiguously (§3.2).  A
fetch span never crosses a group boundary, so assigning whole groups to
shards guarantees every doorbell descriptor names blocks on exactly one
memory node — the invariant that lets ``ShardedPool`` form descriptor
batches per destination.

A ``PlacementPolicy`` owns the group -> shard map and (optionally) its
evolution under load:

* ``RoundRobinPlacement``   — group g lives on shard g % N.  The
  baseline; ignores sizes and heat.
* ``SizeBalancedPlacement`` — greedy LPT over live rows per group, so
  shards hold near-equal bytes even when partition sizes are skewed.
* ``FrequencyAwarePlacement`` — starts round-robin, counts span
  accesses per group, and every ``migrate_every`` accesses plans up to
  ``max_moves`` migrations of the hottest groups away from the most
  loaded (slowest × hottest) shard toward the fastest/least-loaded one.
  Per-shard load is modeled as ``cost_s * hits_s`` where ``cost_s`` is
  the shard's modeled seconds per span read (0 for an in-process
  child), i.e. exactly the term that dominates a parallel fan-out's
  critical path.  Counters decay after each rebalance so stale heat
  ages out instead of pinning history forever.

Replication and capacity (both beyond the policies themselves) are
layered on top by two pure functions:

* ``apply_budgets``     — enforce per-shard byte budgets on an existing
  assignment: an overflowing group spills to the *next-best* shard
  (cheapest, then least loaded, among shards with room), and only when
  no shard has room does it land on the globally least-loaded one — the
  budgets are capacity targets, not hard admission control, because the
  region has to live somewhere.
* ``place_replicated``  — expand a primary assignment to an
  ``(n_groups, n_replicas)`` replica matrix: column 0 is the (budgeted)
  primary, every further column picks a *distinct* shard per group
  ranked by (has-room, cost, load).  ``ShardedPool`` serves reads from
  the fastest/least-loaded live replica and fans writes to all of them.

Policies are stateful and owned by ONE pool each (``place`` resets the
state); ``make_placement`` accepts either a policy name or an instance.
"""
from __future__ import annotations

import abc
from typing import Optional, Sequence, Union

import numpy as np


class PlacementPolicy(abc.ABC):
    """Group -> shard assignment (+ optional migration under load)."""

    name: str = "abstract"

    @abc.abstractmethod
    def place(self, n_groups: int, n_shards: int, *,
              group_sizes: Optional[np.ndarray] = None,
              shard_costs: Optional[Sequence[float]] = None) -> np.ndarray:
        """Initial assignment: (n_groups,) int array of shard indices.
        Resets any per-instance counters."""

    def note_access(self, group: int) -> bool:
        """Record one span access to ``group``.  Returns True when the
        policy wants the pool to run ``plan_moves`` (rebalance due)."""
        return False

    def plan_moves(self, owner: np.ndarray, *,
                   group_sizes: Optional[np.ndarray] = None,
                   shard_costs: Optional[Sequence[float]] = None
                   ) -> list[tuple[int, int, int]]:
        """Migrations to apply now: [(group, src_shard, dst_shard)].
        Static policies return []."""
        return []


class RoundRobinPlacement(PlacementPolicy):
    """Static baseline: group g lives on shard g % n_shards."""

    name = "round_robin"

    def place(self, n_groups: int, n_shards: int, *, group_sizes=None,
              shard_costs=None) -> np.ndarray:
        """See ``PlacementPolicy.place``; sizes and costs are ignored."""
        return np.arange(n_groups, dtype=np.int64) % max(n_shards, 1)


class SizeBalancedPlacement(PlacementPolicy):
    """Greedy LPT on live rows per group: biggest group first, each to
    the currently lightest shard — shards end within one group of even
    byte load even under skewed partition sizes."""

    name = "size_balanced"

    def place(self, n_groups: int, n_shards: int, *, group_sizes=None,
              shard_costs=None) -> np.ndarray:
        """See ``PlacementPolicy.place``; LPT over ``group_sizes``."""
        n_shards = max(n_shards, 1)
        sizes = (np.ones(n_groups) if group_sizes is None
                 else np.asarray(group_sizes, np.float64))
        owner = np.zeros(n_groups, np.int64)
        loads = np.zeros(n_shards, np.float64)
        # stable sort keeps equal-size groups in index order -> with
        # uniform sizes this degrades gracefully to round-robin-like
        for g in np.argsort(-sizes, kind="stable"):
            s = int(np.argmin(loads))
            owner[g] = s
            loads[s] += sizes[g]
        return owner


class FrequencyAwarePlacement(PlacementPolicy):
    """Hot-group migration toward the fastest / least-loaded shard.

    ``note_access`` accumulates per-group span-read counts; every
    ``migrate_every`` accesses the pool is asked to rebalance.  A move
    is accepted only while it strictly lowers the busiest shard's
    modeled time ``cost_s * hits_s`` by at least ``min_gain`` — the
    hysteresis that keeps near-balanced loads from ping-ponging.
    """

    name = "freq"

    def __init__(self, *, migrate_every: int = 512, max_moves: int = 4,
                 decay: float = 0.5, min_gain: float = 0.05):
        self.migrate_every = max(int(migrate_every), 1)
        self.max_moves = max(int(max_moves), 1)
        self.decay = float(decay)
        self.min_gain = float(min_gain)
        self._counts = np.zeros(0, np.float64)
        self._since = 0

    def place(self, n_groups: int, n_shards: int, *, group_sizes=None,
              shard_costs=None) -> np.ndarray:
        """See ``PlacementPolicy.place``; round-robin start, resets the
        access counters that drive later ``plan_moves``."""
        self._counts = np.zeros(n_groups, np.float64)
        self._since = 0
        return np.arange(n_groups, dtype=np.int64) % max(n_shards, 1)

    def note_access(self, group: int) -> bool:
        """See ``PlacementPolicy.note_access``; True every
        ``migrate_every`` accesses."""
        if group < len(self._counts):
            self._counts[group] += 1.0
        self._since += 1
        if self._since >= self.migrate_every:
            self._since = 0
            return True
        return False

    @staticmethod
    def _norm_costs(n_shards: int, shard_costs) -> np.ndarray:
        """Per-shard seconds per span read; all-equal (incl. all-zero,
        the in-process case) collapses to uniform cost 1 so the policy
        still balances pure load."""
        if shard_costs is None:
            return np.ones(n_shards, np.float64)
        c = np.asarray(shard_costs, np.float64)
        if np.allclose(c, c[0]):
            return np.ones(n_shards, np.float64)
        return c

    def plan_moves(self, owner: np.ndarray, *, group_sizes=None,
                   shard_costs=None) -> list[tuple[int, int, int]]:
        """See ``PlacementPolicy.plan_moves``; greedy hottest-group
        moves off the busiest shard while the max load strictly drops."""
        owner = np.asarray(owner).copy()
        n_shards = int(owner.max()) + 1 if len(owner) else 1
        if shard_costs is not None:
            n_shards = max(n_shards, len(shard_costs))
        cost = self._norm_costs(n_shards, shard_costs)
        counts = self._counts[: len(owner)]
        loads = np.array([cost[s] * counts[owner == s].sum()
                          for s in range(n_shards)])
        moves: list[tuple[int, int, int]] = []
        for _ in range(self.max_moves):
            src = int(np.argmax(loads))
            dst = int(np.argmin(loads))
            if src == dst:
                break
            cand = np.nonzero(owner == src)[0]
            cand = cand[counts[cand] > 0]
            if not len(cand):
                break
            g = int(cand[np.argmax(counts[cand])])
            h = counts[g]
            new_src = loads[src] - cost[src] * h
            new_dst = loads[dst] + cost[dst] * h
            # accept only if the pair's max strictly drops (with margin)
            if max(new_src, new_dst) >= loads[src] * (1.0 - self.min_gain):
                break
            loads[src], loads[dst] = new_src, new_dst
            owner[g] = dst
            moves.append((g, src, dst))
        self._counts *= self.decay
        return moves


# ------------------------------------------------------- capacity layer

def _norm_sizes(n_groups: int, group_sizes) -> np.ndarray:
    """Per-group size signal (live rows or bytes); uniform 1 when the
    caller has none — budgets then count groups instead of bytes."""
    if group_sizes is None:
        return np.ones(n_groups, np.float64)
    return np.asarray(group_sizes, np.float64)


def _shard_rank(costs: np.ndarray, loads: np.ndarray) -> np.ndarray:
    """Shards ordered best-first: cheapest (modeled seconds per span)
    wins, load breaks cost ties, index keeps it deterministic."""
    return np.lexsort((np.arange(len(costs)), loads, costs))


def apply_budgets(owner: np.ndarray, *, group_sizes=None,
                  shard_budgets: Optional[Sequence[float]] = None,
                  shard_costs: Optional[Sequence[float]] = None
                  ) -> np.ndarray:
    """Capacity-aware repair of a group -> shard assignment.

    Groups are kept where the policy put them while the owning shard
    stays within its budget (``shard_budgets[s]`` in the same unit as
    ``group_sizes``, typically bytes).  A group that would overflow its
    shard *spills to the next-best shard* — cheapest, then least
    loaded, among the shards that still have room — processed biggest
    group first so the large spans get first pick of the remaining
    capacity.  When every shard is full the group lands on the globally
    least-loaded one: budgets shape placement, they never reject data.
    Returns a new owner array; the input is not mutated.
    """
    owner = np.asarray(owner, np.int64).copy()
    if shard_budgets is None or not len(owner):
        return owner
    n_shards = max(int(owner.max()) + 1, len(shard_budgets))
    sizes = _norm_sizes(len(owner), group_sizes)
    budgets = np.asarray(shard_budgets, np.float64)
    costs = (np.asarray(shard_costs, np.float64) if shard_costs is not None
             else np.zeros(n_shards))
    loads = np.zeros(n_shards, np.float64)
    for g in np.argsort(-sizes, kind="stable"):
        s = int(owner[g])
        if loads[s] + sizes[g] <= budgets[s]:
            loads[s] += sizes[g]
            continue
        room = loads + sizes[g] <= budgets
        cand = _shard_rank(costs, loads)
        cand = [c for c in cand if room[c]]
        s2 = int(cand[0]) if cand else int(np.argmin(loads))
        owner[g] = s2
        loads[s2] += sizes[g]
    return owner


def place_replicated(owner: np.ndarray, n_shards: int, n_replicas: int, *,
                     group_sizes=None,
                     shard_budgets: Optional[Sequence[float]] = None,
                     shard_costs: Optional[Sequence[float]] = None
                     ) -> np.ndarray:
    """Expand a primary assignment into an (n_groups, R) replica matrix.

    Column 0 is ``owner`` verbatim (already budget-repaired by the
    caller); each further column assigns every group one more *distinct*
    shard, chosen best-first by (still-has-room, cost, load) with loads
    accumulated across all columns — so replicas both avoid their own
    primaries and spread by capacity.  ``n_replicas`` is clamped to
    ``n_shards`` (R distinct shards cannot exceed the fleet).
    """
    owner = np.asarray(owner, np.int64)
    r = max(1, min(int(n_replicas), int(n_shards)))
    reps = np.full((len(owner), r), -1, np.int64)
    reps[:, 0] = owner
    if r == 1:
        return reps
    sizes = _norm_sizes(len(owner), group_sizes)
    budgets = (np.asarray(shard_budgets, np.float64)
               if shard_budgets is not None
               else np.full(n_shards, np.inf))
    costs = (np.asarray(shard_costs, np.float64) if shard_costs is not None
             else np.zeros(n_shards))
    loads = np.zeros(n_shards, np.float64)
    for g in range(len(owner)):
        loads[owner[g]] += sizes[g]
    for col in range(1, r):
        for g in np.argsort(-sizes, kind="stable"):
            taken = set(reps[g, :col].tolist())
            cand = [int(s) for s in _shard_rank(costs, loads)
                    if s not in taken]
            with_room = [s for s in cand
                         if loads[s] + sizes[g] <= budgets[s]]
            s = (with_room or cand)[0]
            reps[g, col] = s
            loads[s] += sizes[g]
    return reps


_POLICIES = {
    "round_robin": RoundRobinPlacement,
    "size_balanced": SizeBalancedPlacement,
    "freq": FrequencyAwarePlacement,
}


def make_placement(spec: Union[str, PlacementPolicy, None] = "round_robin",
                   **kw) -> PlacementPolicy:
    """Policy name (or ready instance) -> ``PlacementPolicy``."""
    if spec is None:
        spec = "round_robin"
    if isinstance(spec, PlacementPolicy):
        return spec
    try:
        return _POLICIES[spec](**kw)
    except KeyError:
        raise ValueError(f"unknown placement policy {spec!r} "
                         f"(have {sorted(_POLICIES)})") from None


# ----------------------------------------------------- rescale / rebalance
# (migration planning over the block-contiguous owner mapping — folded in
# from the retired repro.distributed.elastic / .fault_tolerance stubs)

def plan_store_migration(n_blocks: int, old_tp: int, new_tp: int):
    """Block moves for rescaling the memory-pool owner count.

    Returns ``[(src_owner, dst_owner, first_block, n)]`` — contiguous
    spans only (the layout guarantee).  Total moved bytes is the
    rescale cost.
    """
    old_per = -(-n_blocks // old_tp)
    new_per = -(-n_blocks // new_tp)
    moves = []
    b = 0
    while b < n_blocks:
        src = min(b // old_per, old_tp - 1)
        dst = min(b // new_per, new_tp - 1)
        # span until either owner boundary changes
        nxt = min((b // old_per + 1) * old_per,
                  (b // new_per + 1) * new_per, n_blocks)
        if src != dst:
            moves.append((src, dst, b, nxt - b))
        b = nxt
    return moves


def rebalance_partitions(owners, sick: set, n_owners: int):
    """Reassign partitions owned by sick memory instances to the
    least-loaded healthy ones.  The paper's layout makes each migration
    a contiguous copy of one group span.  Returns (new_owners, moves).
    """
    owners = np.asarray(owners).copy()
    healthy = [o for o in range(n_owners) if o not in sick]
    if not healthy:
        raise RuntimeError("no healthy memory instances left")
    load = {o: int((owners == o).sum()) for o in healthy}
    moves = []
    for pid in np.nonzero(np.isin(owners, list(sick)))[0]:
        tgt = min(load, key=load.get)
        moves.append((int(pid), int(owners[pid]), tgt))
        owners[pid] = tgt
        load[tgt] += 1
    return owners, moves

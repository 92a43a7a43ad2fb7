"""Dynamic micro-batching front-end for the d-HNSW engine.

The paper's throughput wins (§3.3 batched query-aware loading, §3.2
doorbell batching) all trigger on the *batch* handed to the engine: one
load per needed partition per batch, many span reads per round trip, and
LRU reuse across the batch.  A serving tier that forwards each user
request as its own ``engine.search`` call forfeits every one of those —
two concurrent users needing the same partition pay two fetches, and
each call eats the fixed meta-route/plan/dispatch overhead alone.

``MicroBatcher`` restores the paper's invariant under live traffic: it
queues concurrent single-query (or small-batch) requests, coalesces them
under a policy (max batch size, max wait, token-bucket admission), and
dispatches ONE fused ``DHNSWEngine.search`` per window.  Cross-request
coalescing is therefore exactly the paper's batched query-aware loading
with the "batch" assembled from independent requesters instead of one
caller: partition dedup, doorbell grouping, and cache reuse all amortize
across users.  Results are scattered back per request together with a
queue/route/plan/fetch/serve latency breakdown, and the batcher keeps
rolling p50/p95/p99 service metrics.

Requests preserve arrival order: a window is drained as consecutive
same-kind runs (search / insert), so a search submitted after an insert
observes the inserted vectors.  With weighted fair queueing enabled
(``BatchPolicy.wfq`` / ``tenant_weight``) windows drain by deficit
round-robin across tenants instead of strict FIFO — per-tenant order is
still preserved (a tenant's search still observes its own earlier
inserts), but one tenant's backlog can no longer monopolize windows:
served rows converge to the configured weight ratio, reported as the
per-tenant ``share`` in ``stats()["tenants"]``.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.engine import pow2_pad
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.trace import TRACER


class AdmissionError(RuntimeError):
    """Token-bucket admission rejected a request (over offered-load cap)."""


@dataclass
class BatchPolicy:
    """Coalescing policy for one batcher.

    A window opens when the queue goes non-empty and closes when either
    ``max_batch`` query rows are pending or the oldest request has waited
    the window's wait budget.  ``rate``/``burst`` bound admission
    (0 = unlimited).

    With ``adaptive_wait`` the budget scales with the OBSERVED arrival
    rate instead of sitting at ``max_wait_s``: under load the queue
    fills a batch quickly so holding the window only adds latency (the
    budget shrinks toward ``min_wait_s``); when traffic is sparse a
    longer window is the only way requests ever coalesce (the budget
    grows toward ``max_wait_s``).  ``max_wait_s`` is always the cap.
    A window whose opening request found the queue EMPTY at enqueue
    time collapses straight to ``min_wait_s``: nothing was waiting to
    coalesce with it, so holding the window open is pure added latency.
    """

    max_batch: int = 64         # query rows fused into one engine call
    max_wait_s: float = 2e-3    # wait cap (fixed budget when not adaptive)
    rate: float = 0.0           # admission tokens/s (0 disables the bucket)
    burst: int = 64             # bucket depth
    admission_block: bool = True  # block when out of tokens (else raise)
    adaptive_wait: bool = False   # scale the window from arrival EWMA
    min_wait_s: float = 1e-4      # adaptive floor
    ewma_alpha: float = 0.2       # inter-arrival smoothing
    # per-tenant admission: every search request carries a ``tenant``
    # key (default "-"); each tenant gets its OWN token bucket on top of
    # the global one, so one tenant flooding the queue cannot starve the
    # rest of their admission budget (0 disables per-tenant buckets)
    tenant_rate: float = 0.0    # admission tokens/s per tenant
    tenant_burst: int = 32      # per-tenant bucket depth
    # weighted fair queueing: with ``wfq`` (or any explicit
    # ``tenant_weight``) the window drains queued requests by deficit
    # round-robin across tenants instead of FIFO — each tenant earns
    # ``wfq_quantum * weight`` query rows of credit per sweep, so a
    # backlogged tenant cannot monopolize a window and served capacity
    # converges to the weight ratio.  Arrival order is preserved
    # WITHIN a tenant (a tenant's search still observes its own earlier
    # inserts); cross-tenant order is intentionally not preserved.
    wfq: bool = False
    tenant_weight: dict = field(default_factory=dict)   # tenant -> weight
    wfq_quantum: int = 8        # rows of credit per weight unit per sweep
    # latency SLOs (repro.obs.slo): a single spec ("p99<5ms" or an SLO)
    # watches end-to-end request latency per tenant; a {tier: spec} dict
    # attaches objectives per stage ("serve" end-to-end, "fetch" pool
    # wire time, "queue" wait).  None disables SLO tracking entirely.
    slo: Optional[object] = None
    slo_short_window: int = 64   # burn-rate fast window (requests)
    slo_long_window: int = 512   # burn-rate slow window (requests)

    @property
    def fair_queue(self) -> bool:
        return self.wfq or bool(self.tenant_weight)

    def weight_of(self, tenant: str) -> float:
        return max(float(self.tenant_weight.get(tenant, 1.0)), 1e-6)


class ArrivalRateEWMA:
    """EWMA of request inter-arrival time -> adaptive window budget.

    The budget is the time it takes (at the observed rate) for half a
    ``max_batch`` to queue up: enough to coalesce, never so long that a
    full batch sits waiting on a timer.  Thread-safe; all methods take
    an explicit ``now`` so tests can drive synthetic clocks.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._ewma: Optional[float] = None    # smoothed inter-arrival (s)
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, now: float) -> None:
        with self._lock:
            if self._last is not None:
                dt = max(now - self._last, 0.0)
                self._ewma = (dt if self._ewma is None else
                              self.alpha * dt + (1 - self.alpha) * self._ewma)
            self._last = now

    def interarrival_s(self) -> Optional[float]:
        with self._lock:
            return self._ewma

    def wait_budget_s(self, policy: "BatchPolicy",
                      queue_empty: bool = False) -> float:
        if not policy.adaptive_wait:
            return policy.max_wait_s
        if queue_empty:
            # the opener found nothing queued behind it: holding the
            # window cannot coalesce what isn't there — dispatch fast
            return policy.min_wait_s
        with self._lock:
            ewma = self._ewma
        if ewma is None:                      # no signal yet: cap
            return policy.max_wait_s
        target = 0.5 * policy.max_batch * ewma
        return float(min(max(target, policy.min_wait_s), policy.max_wait_s))


class TokenBucket:
    """Classic token bucket; thread-safe; ``rate<=0`` admits everything."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(int(burst), 1)
        self._tokens = float(self.burst)
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, n: int = 1, *, block: bool = True) -> bool:
        if self.rate <= 0:
            return True
        # a request larger than the bucket depth drains the whole bucket
        # (n > burst could otherwise never be satisfied and would spin)
        n = min(n, self.burst)
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._t) * self.rate)
                self._t = now
                if self._tokens >= n:
                    self._tokens -= n
                    return True
                need = (n - self._tokens) / self.rate
            if not block:
                return False
            time.sleep(min(need, 0.05))


@dataclass
class _Request:
    kind: str                   # "search" | "insert"
    vecs: np.ndarray            # (m, D)
    k: int
    t_submit: float
    tenant: str = "-"
    future: Future = field(default_factory=Future)
    # whether the queue was empty the instant this request was enqueued
    # (adaptive_wait collapses the window to min_wait_s on a lone opener)
    empty_at_enqueue: bool = False


class ServeMetrics:
    """Rolling per-request latency + stage breakdown (thread-safe)."""

    WINDOW = 8192               # per-request latencies kept for percentiles

    def __init__(self):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=self.WINDOW)
        self.n_requests = 0
        self.n_queries = 0
        self.n_fused_calls = 0
        self.n_rejected = 0
        self.fused_sizes = deque(maxlen=self.WINDOW)
        self.breakdown = {"queue_s": 0.0, "route_s": 0.0, "plan_s": 0.0,
                          "fetch_s": 0.0, "serve_s": 0.0}
        # NetLedger roll-up, recorded once per fused CALL (every request
        # in a window shares one engine call's network events)
        self.net = {"bytes_fetched": 0.0, "bytes_saved": 0.0,
                    "round_trips": 0.0, "descriptors": 0.0}
        # per-tenant admission accounting: admitted/rejected counters,
        # the live queue depth (enqueued minus dispatched), and served
        # query rows (-> served share under weighted fair queueing)
        self.tenants: dict[str, dict] = {}
        # latest memory-pool snapshot (verb totals; per-shard breakdown
        # when the engine serves through a ShardedPool)
        self.pool_snap: Optional[dict] = None
        # engine-side counters folded across fused calls (cache hit
        # ratio, fetches, rounds) for the Prometheus exporter
        self.engine_agg = {"cache_hits": 0.0, "n_fetches": 0.0,
                           "n_rounds": 0.0}
        # per-tenant/per-tier SLO evaluation; attached by MicroBatcher
        # when BatchPolicy.slo is configured, else stays None
        self.slo: Optional[SLOTracker] = None

    def _tenant(self, tenant: str) -> dict:
        """Caller must hold the lock."""
        return self.tenants.setdefault(
            tenant, {"admitted": 0, "rejected": 0, "queued": 0,
                     "served": 0})

    def note_enqueued(self, tenant: str):
        with self._lock:
            t = self._tenant(tenant)
            t["admitted"] += 1
            t["queued"] += 1

    def note_dequeued(self, tenant: str):
        with self._lock:
            self._tenant(tenant)["queued"] -= 1

    def note_served(self, tenant: str, rows: int):
        """Rows that actually completed (not merely dispatched): a
        window whose engine call raises must not inflate the fair-queue
        served share."""
        with self._lock:
            self._tenant(tenant)["served"] += rows

    def record_call(self, batch: int, n_queries: int = 0,
                    net: Optional[dict] = None,
                    pool: Optional[dict] = None,
                    engine: Optional[dict] = None):
        with self._lock:
            self.n_fused_calls += 1
            self.fused_sizes.append(batch)
            self.n_queries += n_queries
            if net:
                self.net["bytes_fetched"] += net.get("bytes", 0.0)
                self.net["bytes_saved"] += net.get("bytes_saved", 0.0)
                self.net["round_trips"] += net.get("round_trips", 0.0)
                self.net["descriptors"] += net.get("descriptors", 0.0)
            if pool is not None:
                self.pool_snap = pool
            if engine:
                for key in self.engine_agg:
                    self.engine_agg[key] += float(engine.get(key, 0.0))

    def record_rejected(self, tenant: str = "-"):
        with self._lock:
            self.n_rejected += 1
            self._tenant(tenant)["rejected"] += 1

    def record_request(self, total_s: float, breakdown: dict,
                       tenant: str = "-"):
        with self._lock:
            self.n_requests += 1
            self._lat.append(total_s)
            for key in self.breakdown:
                self.breakdown[key] += breakdown.get(key, 0.0)
            if self.slo is not None:
                # feed every configured tier; record() ignores the rest
                self.slo.record("serve", tenant, total_s)
                for tier, key in (("fetch", "fetch_s"),
                                  ("queue", "queue_s")):
                    if key in breakdown:
                        self.slo.record(tier, tenant, breakdown[key])

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            sizes = np.asarray(self.fused_sizes, np.float64)
            out = {
                "n_requests": self.n_requests,
                "n_queries": self.n_queries,
                "n_fused_calls": self.n_fused_calls,
                "n_rejected": self.n_rejected,
                "mean_fused_batch": float(sizes.mean()) if len(sizes) else 0.0,
                "breakdown_s": dict(self.breakdown),
                "net": dict(self.net),
                "engine": dict(self.engine_agg),
                "tenants": {t: dict(v) for t, v in self.tenants.items()},
            }
            total_served = sum(v["served"] for v in self.tenants.values())
            for v in out["tenants"].values():
                v["share"] = (v["served"] / total_served
                              if total_served else 0.0)
            if self.pool_snap is not None:
                out["pool"] = copy.deepcopy(self.pool_snap)
                # remote transports: roll the MEASURED wire traffic up
                # next to the modeled ledger totals under ``net``
                wt = (self.pool_snap.get("wire_total")
                      or self.pool_snap.get("wire"))
                if wt:
                    out["net"]["wire_frames"] = (wt["frames_tx"]
                                                 + wt["frames_rx"])
                    out["net"]["wire_bytes_tx"] = wt["bytes_tx"]
                    out["net"]["wire_bytes_rx"] = wt["bytes_rx"]
                # replicated pools: surface liveness + failover next to
                # the latency numbers so an operator sees a mid-run node
                # death (deaths > 0, alive count down) without digging
                # through the full per-shard snapshot
                if "failover" in self.pool_snap:
                    out["failover"] = dict(self.pool_snap["failover"])
                    out["failover"]["replication"] = self.pool_snap.get(
                        "replication", 1)
                    alive = self.pool_snap.get("alive")
                    if alive is not None:
                        out["failover"]["alive_shards"] = int(sum(alive))
                    out["failover"]["trace_harvest_failures"] = (
                        self.pool_snap.get("trace_harvest_failures", 0))
                # straggler verdicts ride next to the latency numbers:
                # "p99 moved AND shard 1 is flagged" is one glance
                if "stragglers" in self.pool_snap:
                    out["stragglers"] = copy.deepcopy(
                        self.pool_snap["stragglers"])
            if self.slo is not None:
                out["slo"] = self.slo.report()
            for p in (50, 95, 99):
                out[f"p{p}_ms"] = (float(np.percentile(lat, p)) * 1e3
                                   if len(lat) else 0.0)
            return out


class MicroBatcher:
    """Queue + dispatcher thread around one ``DHNSWEngine``.

    ``submit_search``/``submit_insert`` enqueue and return a ``Future``;
    the dispatcher coalesces pending requests into fused engine calls.
    The engine is only ever touched from the dispatcher thread, so the
    (not thread-safe) engine needs no internal locking.
    """

    def __init__(self, engine, policy: Optional[BatchPolicy] = None, *,
                 autostart: bool = True):
        self.engine = engine
        self.policy = policy or BatchPolicy()
        self.metrics = ServeMetrics()
        if self.policy.slo is not None:
            self.metrics.slo = SLOTracker(
                self.policy.slo,
                short_window=self.policy.slo_short_window,
                long_window=self.policy.slo_long_window)
        self.arrivals = ArrivalRateEWMA(self.policy.ewma_alpha)
        self._bucket = TokenBucket(self.policy.rate, self.policy.burst)
        self._tenant_buckets: dict[str, TokenBucket] = {}
        self._tenant_lock = threading.Lock()
        # weighted-fair-queueing state (deficit round-robin): per-tenant
        # row credit and the tenant service order, persisted across
        # windows so short-term bursts even out.  The sweep start
        # rotates every window so a window that fills before reaching
        # the last tenants cannot starve them forever; tenants with no
        # backlog are pruned (their credit is zero by construction).
        self._deficit: dict[str, float] = {}
        self._rr: list[str] = []
        self._rr_pos = 0
        self._queue: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "MicroBatcher":
        if self._thread is None or not self._thread.is_alive():
            # one live dispatcher per engine: the engine is not
            # thread-safe, and two batchers racing it would corrupt the
            # LRU/cache state the serialization exists to protect
            owner = getattr(self.engine, "_dispatcher", None)
            if (owner is not None and owner is not self
                    and owner._thread is not None
                    and owner._thread.is_alive()):
                raise RuntimeError(
                    "engine already has a live MicroBatcher; stop it first")
            if self.engine is not None:
                self.engine._dispatcher = self
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dhnsw-batcher")
            self._thread.start()
        return self

    def stop(self, *, flush: bool = True):
        """Stop the dispatcher; by default drain queued requests first."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            # unbounded join: an in-flight fused call (e.g. a cold XLA
            # compile) can exceed any timeout, and draining or handing
            # the engine to a new batcher while the dispatcher is still
            # inside it would break the single-thread engine invariant
            self._thread.join()
        if flush:
            self._drain_all()
        if getattr(self.engine, "_dispatcher", None) is self:
            self.engine._dispatcher = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ submit

    def _tenant_bucket(self, tenant: str) -> Optional[TokenBucket]:
        if self.policy.tenant_rate <= 0:
            return None
        with self._tenant_lock:
            bucket = self._tenant_buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.policy.tenant_rate,
                                     self.policy.tenant_burst)
                self._tenant_buckets[tenant] = bucket
            return bucket

    def submit_search(self, vecs: np.ndarray, k: int = 10, *,
                      tenant: str = "-") -> Future:
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        # tenant bucket FIRST: a tenant-rejected request must not have
        # consumed shared global tokens, or a flooding tenant would
        # still drain everyone else's admission budget
        with TRACER.span("serve.admit", tier="serve", tenant=tenant,
                         rows=int(vecs.shape[0])):
            tb = self._tenant_bucket(tenant)
            if tb is not None and not tb.acquire(
                    vecs.shape[0], block=self.policy.admission_block):
                self.metrics.record_rejected(tenant)
                raise AdmissionError(
                    f"tenant {tenant!r} over its admission rate")
            if not self._bucket.acquire(vecs.shape[0],
                                        block=self.policy.admission_block):
                self.metrics.record_rejected(tenant)
                raise AdmissionError(
                    "token bucket empty (offered load over cap)")
        return self._enqueue(_Request("search", vecs, int(k),
                                      time.perf_counter(), tenant))

    def submit_insert(self, vecs: np.ndarray, *,
                      tenant: str = "-") -> Future:
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        return self._enqueue(_Request("insert", vecs, 0,
                                      time.perf_counter(), tenant))

    def search(self, vecs: np.ndarray, k: int = 10, *, tenant: str = "-"):
        """Blocking convenience: returns (dists, gids, stats)."""
        return self.submit_search(vecs, k, tenant=tenant).result()

    def insert(self, vecs: np.ndarray, *, tenant: str = "-") -> np.ndarray:
        return self.submit_insert(vecs, tenant=tenant).result()

    def _enqueue(self, req: _Request) -> Future:
        self.arrivals.observe(req.t_submit)
        with self._cv:
            if self._stop and self._thread is not None:
                raise RuntimeError("batcher is stopped")
            req.empty_at_enqueue = not self._queue
            self._queue.append(req)
            self.metrics.note_enqueued(req.tenant)
            self._cv.notify_all()
        return req.future

    # ------------------------------------------------------------ dispatcher

    def _run(self):
        pol = self.policy
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
                # window: open at the oldest pending request; close on
                # max_batch rows queued or the oldest exhausting the wait
                # budget (arrival-rate-adaptive when the policy says so)
                deadline = (self._queue[0].t_submit
                            + self.arrivals.wait_budget_s(
                                pol,
                                queue_empty=self._queue[0].empty_at_enqueue))
                while (sum(r.vecs.shape[0] for r in self._queue)
                       < pol.max_batch):
                    left = deadline - time.perf_counter()
                    if left <= 0 or self._stop:
                        break
                    self._cv.wait(timeout=left)
                window = self._take_window()
            self._dispatch_window(window)

    def _take_window(self) -> list[_Request]:
        """Pop up to max_batch query rows.  FIFO by default; deficit
        round-robin across tenants when the policy enables weighted
        fair queueing (per-tenant arrival order always preserved)."""
        if self.policy.fair_queue:
            return self._take_window_drr()
        out, rows = [], 0
        while self._queue and rows < self.policy.max_batch:
            rows += self._queue[0].vecs.shape[0]
            out.append(self._queue.popleft())
        return out

    def _take_window_drr(self) -> list[_Request]:
        """Deficit round-robin: sweep tenants in first-seen order, top
        each deficit up by ``wfq_quantum * weight`` rows per sweep, and
        pop that tenant's queue head while the deficit affords it — so
        over time every backlogged tenant's served rows converge to the
        weight ratio no matter how deep anyone's backlog is."""
        pol = self.policy
        pending: dict[str, deque] = {}
        for r in self._queue:
            pending.setdefault(r.tenant, deque()).append(r)
        for t in pending:
            if t not in self._deficit:
                self._deficit[t] = 0.0
                self._rr.append(t)
        # rotate the sweep start each window: a window that fills at
        # max_batch before reaching the tail tenants must not restart
        # at the same head next time (that would starve the tail)
        self._rr_pos %= max(len(self._rr), 1)
        order = self._rr[self._rr_pos:] + self._rr[:self._rr_pos]
        self._rr_pos += 1
        out: list[_Request] = []
        rows = 0
        while rows < pol.max_batch and any(pending.values()):
            progressed = False
            for t in order:
                q = pending.get(t)
                if not q:
                    continue
                self._deficit[t] += pol.wfq_quantum * pol.weight_of(t)
                while q and rows < pol.max_batch:
                    need = q[0].vecs.shape[0]
                    if self._deficit[t] < need:
                        break
                    self._deficit[t] -= need
                    out.append(q.popleft())
                    rows += need
                    progressed = True
                if rows >= pol.max_batch:
                    break
            if not progressed and rows < pol.max_batch:
                # no tenant could afford its queue head this pass (a
                # pathological near-zero weight would otherwise spin
                # this loop for ~need/quantum*weight passes while
                # HOLDING the batcher lock): force the first backlogged
                # head through at zero carried credit and move on
                for t in order:
                    q = pending.get(t)
                    if q:
                        self._deficit[t] = 0.0
                        r = q.popleft()
                        out.append(r)
                        rows += r.vecs.shape[0]
                        break
        # a tenant whose backlog drained carries no credit forward
        # (classic DRR: deficit only accumulates while backlogged), and
        # keeping it listed would grow the sweep without bound on
        # long-lived servers with many tenant keys — prune it
        drained = [t for t, q in pending.items() if not q]
        if drained:
            gone = set(drained)
            self._rr = [t for t in self._rr if t not in gone]
            for t in drained:
                self._deficit.pop(t, None)
        taken = {id(r) for r in out}
        self._queue = deque(r for r in self._queue if id(r) not in taken)
        return out

    def _drain_all(self):
        while True:
            with self._cv:
                window = self._take_window()
            if not window:
                return
            self._dispatch_window(window)

    def _dispatch_window(self, window: list[_Request]):
        """Split the window into consecutive same-kind runs (preserving
        submission order for insert/search interleave) and fuse each."""
        i = 0
        while i < len(window):
            j = i
            while j < len(window) and window[j].kind == window[i].kind:
                j += 1
            group = window[i:j]
            for r in group:
                self.metrics.note_dequeued(r.tenant)
            with TRACER.span("serve.window", tier="serve",
                             kind=group[0].kind, requests=len(group),
                             rows=int(sum(r.vecs.shape[0] for r in group))):
                try:
                    if group[0].kind == "search":
                        self._dispatch_search(group)
                    else:
                        self._dispatch_insert(group)
                except BaseException as e:  # deliver, don't kill the thread
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
            i = j

    def _dispatch_search(self, group: list[_Request]):
        t_disp = time.perf_counter()
        if TRACER.enabled:
            for r in group:
                TRACER.add("serve.queue", "serve", r.t_submit,
                           t_disp - r.t_submit, tenant=r.tenant,
                           rows=int(r.vecs.shape[0]))
        with TRACER.span("serve.fuse", tier="serve", requests=len(group)):
            fused = np.concatenate([r.vecs for r in group])
            # one engine call at the max requested k: top-k lists are
            # prefix-consistent, so each request slices its own k back out
            k = max(r.k for r in group)
            B = fused.shape[0]
            # bucket the fused batch to a power of two so jitted engine
            # stages see a bounded set of shapes (each distinct B is its
            # own XLA compile); pad rows duplicate query 0, which §3.3
            # dedup makes free on the fetch path
            Bpad = pow2_pad(B, lo=1)
            if Bpad > B:
                fused = np.concatenate(
                    [fused, np.repeat(fused[:1], Bpad - B, axis=0)])
        with TRACER.span("serve.dispatch", tier="serve", batch=int(Bpad),
                         rows=int(B), k=int(k)):
            d, g, est = self.engine.search(fused, k=k)
        d, g = d[:B], g[:B]
        t_done = time.perf_counter()
        self.metrics.record_call(
            B, n_queries=B, net=est["net"], pool=est.get("pool"),
            engine={k2: est.get(k2, 0) for k2 in
                    ("cache_hits", "n_fetches", "n_rounds")})
        with TRACER.span("serve.merge", tier="serve", requests=len(group)):
            off = 0
            for r in group:
                m = r.vecs.shape[0]
                stats = copy.deepcopy(est)   # each request owns its stats
                                             # (est nests the net dict)
                stats["queue_s"] = t_disp - r.t_submit
                stats["route_s"] = est["meta_s"]
                stats["fetch_s"] = est["net"]["latency_s"]
                stats["serve_s"] = est["sub_s"]
                stats["fused_batch"] = B
                stats["total_s"] = t_done - r.t_submit
                self.metrics.record_request(stats["total_s"], {
                    "queue_s": stats["queue_s"], "route_s": est["meta_s"],
                    "plan_s": est["plan_s"], "fetch_s": stats["fetch_s"],
                    "serve_s": est["sub_s"]}, tenant=r.tenant)
                r.future.set_result((d[off:off + m, :r.k],
                                     g[off:off + m, :r.k], stats))
                self.metrics.note_served(r.tenant, m)
                off += m

    def _dispatch_insert(self, group: list[_Request]):
        t_disp = time.perf_counter()
        if TRACER.enabled:
            for r in group:
                TRACER.add("serve.queue", "serve", r.t_submit,
                           t_disp - r.t_submit, tenant=r.tenant,
                           rows=int(r.vecs.shape[0]))
        fused = np.concatenate([r.vecs for r in group])
        with TRACER.span("serve.dispatch", tier="serve",
                         rows=int(fused.shape[0]), kind="insert"):
            gids = self.engine.insert(fused)
        t_done = time.perf_counter()
        self.metrics.record_call(fused.shape[0],
                                 net=getattr(self.engine,
                                             "_last_insert_net", None))
        off = 0
        for r in group:
            m = r.vecs.shape[0]
            self.metrics.record_request(t_done - r.t_submit,
                                        {"queue_s": t_disp - r.t_submit},
                                        tenant=r.tenant)
            r.future.set_result(np.asarray(gids[off:off + m]))
            self.metrics.note_served(r.tenant, m)
            off += m

"""ComputeClient — the compute-pool node of the disaggregated system.

Port of ``repro/pool/compute.py``.  It owns what the paper lets a compute
instance hold: the cached representative meta-HNSW, the resident-partition
cache tiers, the round scheduler, and the device serve path.  Every byte
of index data it touches arrives through a ``MemoryPool`` verb.

It covers ``build`` / ``adopt_built``, exact search (``quant="none"``,
both search modes, all three schemes), the int8 staged search in every
configuration, and ``insert`` through the pool ``append`` verb (with the
group repack and the full rebuild it falls back to).  Its stage 1 is routed as the
reference routes it: the dense-resident flat scan (``quant_kernel``
"auto" or "ref", ``search_mode="scan"``, a quantized tier that holds
every partition) runs ``kernels/quant_topk`` — the CUDA kernel on the
card ("auto") or its plain torch version ("ref", and every tensor on the
CPU); every other int8 configuration runs the per-pair stage 1 over the
quantized tier's device slots (``_stage1_pairs``).

The flat view keeps a device twin of its payload columns (``_flat_cols``:
gid, region row, pid), which the reference reads from host arrays; an
insert that extends the view writes its row there too.

Device tensors use the reference's dtypes: with JAX's default x32, gids,
pids and payloads are int32 until the results are cast to int64 at the
end of a search.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import device_store as DS
from repro_torch.core import layout as LA
from repro_torch.core import meta as ME
from repro_torch.core import scheduler as SCH
from repro_torch.core import search as S
from repro_torch.core.cost_model import NetLedger
from repro_torch.core.hnsw import HNSWParams
from repro_torch.core.scheduler import pow2_pad
from repro_torch.obs.trace import TRACER
from repro_torch.pool.protocol import MemoryPool


class ComputeClient:
    """Plans greedy search against a ``MemoryPool`` (build once, then
    ``search`` batches) with every tensor on ``device``."""

    def __init__(self, cfg, pool_factory, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._pool_factory = pool_factory   # Store -> MemoryPool
        self.pool: Optional[MemoryPool] = None
        self.meta: Optional[ME.MetaIndex] = None
        self.tiers: Optional[SCH.TieredCacheState] = None
        self._extra: dict[int, np.ndarray] = {}   # inserted gid -> vector
        self._extra_pid: dict[int, int] = {}
        self._n0 = 0                              # base dataset size
        self._data: Optional[np.ndarray] = None
        self._last_insert_net: Optional[dict] = None
        # dense-resident flat stage-1 state (quant_kernel route)
        self._flat_synced = False
        self._flat_idx = None

    @property
    def store(self):
        """The pool's host ``Store``."""
        return self.pool.store

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------ build

    def build(self, data: np.ndarray) -> "ComputeClient":
        """Partition ``data``, build the meta-HNSW + serialized region on
        the host, hand the region to the pool, and warm the caches."""
        cfg = self.cfg
        data = np.asarray(data, np.float32)
        self._data = data
        self._n0 = data.shape[0]
        self.meta = ME.build_meta(data, cfg.n_rep, seed=cfg.seed,
                                  meta_levels=cfg.meta_levels)
        store = LA.build_store(
            data, self.meta,
            sub_params=HNSWParams(M=max(cfg.sub_M0 // 2, 2), M0=cfg.sub_M0,
                                  ef_construction=cfg.ef_construction))
        self._adopt(store)
        return self

    def adopt_built(self, meta: ME.MetaIndex, store,
                    data: np.ndarray) -> "ComputeClient":
        """Wire a meta + region built elsewhere (another engine, or state
        carried across by ``repro_torch.convert``) into the client and
        warm the same caches ``build`` would."""
        self._data = data
        self._n0 = data.shape[0]
        self.meta = meta
        self._adopt(store)
        return self

    def _adopt(self, store) -> None:
        cfg = self.cfg
        self.pool = self._pool_factory(store)
        # compute pool (cached, replicated): the meta-HNSW
        self._meta_vecs = self._t(self.meta.graph.vectors, torch.float32)
        self._meta_adj = self._t(self.meta.graph.adjacency, torch.int32)
        self._meta_entry = int(self.meta.graph.entry)
        cap = max(2, int(np.ceil(cfg.cache_frac * self.meta.n_partitions)))
        self._cap0 = cap
        self._setup_caches(cap)

    def _span_cache(self, cap: int, dtype, width: int, fill):
        spec = self.pool.spec
        return torch.full((cap, spec.fetch_blocks, width), fill, dtype=dtype,
                          device=self.device)

    def _setup_caches(self, cap: int):
        cfg = self.cfg
        if cfg.quant == "none":
            self.tiers = None
            self.cache = SCH.LRUCacheState(cap)
            spec = self.pool.spec
            self._cache_g = self._span_cache(cap, torch.int32, spec.gblk, -1)
            self._cache_v = self._span_cache(cap, torch.float32, spec.vblk, 0)
        else:
            self._setup_quant(cap)
        self._flat_synced = False

    def _setup_quant(self, cap: int):
        """Attach the int8 mirror and size the two device tiers from the
        SAME byte budget a quant="none" engine would spend on ``cap``
        full-precision slots: a small exact tier (``exact_frac`` of the
        budget) plus a quantized tier filling the remainder (~3-4x the
        partitions per byte)."""
        cfg = self.cfg
        st = self.pool.store
        if (st.qvec_buf is not None
                and st.spec.quant_group == cfg.quant_group):
            self.pool._stage_quant()
        else:
            self.pool.attach_quant(cfg.quant_group)
        spec = self.pool.spec
        pb = spec.partition_bytes()
        qpb = spec.quant_partition_bytes(
            include_graph=cfg.search_mode == "graph")
        exact_cap = max(1, int(round(cap * cfg.exact_frac)))
        quant_cap = max(2, int((cap - exact_cap) * pb // qpb))
        self.tiers = SCH.TieredCacheState(quant_cap, exact_cap)
        self.cache = self.tiers.exact
        self._cache_g = self._span_cache(exact_cap, torch.int32, spec.gblk, -1)
        self._cache_v = self._span_cache(exact_cap, torch.float32, spec.vblk,
                                         0)
        self._cache_qg, self._cache_qv, self._cache_qs = self._quant_slots(
            quant_cap)

    def _quant_slots(self, cap: int):
        """Empty quantized-tier slots: graph blocks, int8 codes and the
        codebook scales of ``cap`` spans."""
        spec = self.pool.spec
        return (self._span_cache(cap, torch.int32, spec.gblk, -1),
                self._span_cache(cap, torch.int8, spec.vblk, 0),
                self._span_cache(cap, torch.float32, spec.n_qgroups, 0))

    def _lookup(self, gids: np.ndarray) -> np.ndarray:
        out = np.zeros((len(gids), self.pool.spec.dim), np.float32)
        for i, g in enumerate(int(x) for x in gids):
            out[i] = self._data[g] if g < self._n0 else self._extra[g]
        return out

    # ------------------------------------------------------------ search

    def _route(self, q_dev, b: int) -> np.ndarray:
        """Meta-HNSW routing — cached in the compute pool, no network."""
        pids, _ = S.meta_route(self._meta_vecs, self._meta_adj, q_dev,
                               self._meta_entry, b=b,
                               n_levels=self.meta.graph.n_levels)
        return pids.cpu().numpy()

    def search(self, queries: np.ndarray, k: int = 10,
               ef: Optional[int] = None, b: Optional[int] = None):
        """Batched top-k.  Returns (dists (B,k) f32, gids (B,k) int64,
        stats) as numpy arrays."""
        cfg = self.cfg
        ef = ef or cfg.ef
        b = b or cfg.b
        if cfg.quant != "none":
            return self._search_quant(queries, k=k, ef=ef, b=b)
        pool = self.pool
        spec = pool.spec
        queries = np.ascontiguousarray(queries, np.float32)
        B = queries.shape[0]
        q_dev = self._t(queries)
        ledger = NetLedger(cfg.fabric)
        stats = {"meta_s": 0.0, "sub_s": 0.0, "plan_s": 0.0,
                 "n_rounds": 0, "n_pairs": 0}

        t0 = time.perf_counter()
        pids = self._route(q_dev, b)
        stats["meta_s"] = time.perf_counter() - t0
        TRACER.add("compute.route", "compute", t0, stats["meta_s"], B=B)

        # plan (compute-instance CPU role)
        t0 = time.perf_counter()
        # a sharded pool keys each round's doorbell batches by the
        # destination shard
        owner_of = getattr(pool, "owner_of_pid", None)
        if cfg.mode == "naive":
            raw = SCH.naive_plan(pids)
            # every pair is its own READ round trip; dedup below is
            # compute-only, so movement through the pool goes uncharged
            pool.post_span_reads(len(raw), ledger=ledger, doorbell=1,
                                 pids=[p for _, p in raw])
            uniq = sorted({p for _, p in raw})
            cache = SCH.LRUCacheState(max(len(uniq), 1))
            plan = SCH.plan_batch(pids, cache, doorbell=1)
        else:
            plan = SCH.plan_batch(pids, self.cache, doorbell=cfg.doorbell,
                                  owner_of=owner_of)
        stats["plan_s"] = time.perf_counter() - t0
        TRACER.add("compute.plan", "compute", t0, stats["plan_s"],
                   rounds=len(plan.rounds), fetches=plan.n_fetches,
                   hits=plan.n_cache_hits)

        # rounds: fetch -> serve -> merge, all on the device; the running
        # top-k is carried as (B, k) device tensors
        mt_dev = pool.read_meta()
        run_d = torch.full((B, k), torch.inf, dtype=torch.float32,
                           device=self.device)
        run_g = torch.full((B, k), -1, dtype=torch.int32, device=self.device)
        if cfg.mode == "naive":
            cap = cache.capacity
            cache_g = self._span_cache(cap, torch.int32, spec.gblk, -1)
            cache_v = self._span_cache(cap, torch.float32, spec.vblk, 0)
            fetch_ledger = None          # naive pre-charged every demand
            fetch_doorbell = 1
        else:
            cache_g, cache_v = self._cache_g, self._cache_v
            fetch_ledger = ledger
            fetch_doorbell = 1 if cfg.mode == "no_doorbell" else cfg.doorbell

        for rnd in plan.rounds:
            stats["n_rounds"] += 1
            with TRACER.span("compute.round", tier="compute",
                             fetch=int(len(rnd.fetch_pids)),
                             pairs=int(len(rnd.serve_pairs))):
                if len(rnd.fetch_pids):
                    with TRACER.span("compute.fetch", tier="compute",
                                     spans=int(len(rnd.fetch_pids))):
                        g_blocks, v_blocks = pool.read_spans(
                            rnd.fetch_pids, ledger=fetch_ledger,
                            doorbell=fetch_doorbell)
                        DS.write_slots(spec, cache_g, cache_v,
                                       self._t(rnd.fetch_slots), g_blocks,
                                       v_blocks)
                if not len(rnd.serve_pairs):
                    continue
                t0 = time.perf_counter()
                n = len(rnd.serve_pairs)
                qi, ppid, pslot, prank, valid = rnd.serve_tensors(
                    pow2_pad(n), B)
                # n_lanes is b: a query never has more than b pairs in
                # one round
                run_d, run_g = DS.serve_and_merge(
                    spec, cache_g, cache_v, mt_dev, q_dev, run_d, run_g,
                    self._t(qi), self._t(ppid), self._t(pslot),
                    self._t(prank), self._t(valid), k=k, ef=ef,
                    mode=cfg.search_mode, n_lanes=b)
                dt = time.perf_counter() - t0
                stats["sub_s"] += dt
                TRACER.add("compute.serve", "compute", t0, dt, pairs=n)
                stats["n_pairs"] += n

        t0 = time.perf_counter()
        run_d = run_d.cpu().numpy()
        run_g = run_g.cpu().numpy().astype(np.int64)
        stats["sub_s"] += time.perf_counter() - t0
        stats["net"] = ledger.as_dict()
        stats["round_trips_per_query"] = ledger.round_trips / max(B, 1)
        stats["cache_hits"] = plan.n_cache_hits
        stats["n_fetches"] = plan.n_fetches
        stats["pool"] = pool.snapshot()
        return run_d, run_g, stats

    # ------------------------------------------------------ staged search

    def _search_quant(self, queries: np.ndarray, k: int, ef: int, b: int):
        """Two-stage search over the quantized resident tier: stage 1 pools
        per-query top-m candidates with their exact-row addresses, stage 2
        fetches ONLY the candidate rows in full precision (rows of
        exact-tier-resident partitions are free) and re-ranks."""
        cfg = self.cfg
        pool = self.pool
        spec = pool.spec
        pb = spec.partition_bytes()
        qpb = spec.quant_partition_bytes(
            include_graph=cfg.search_mode == "graph")
        row_b = spec.row_bytes()
        m = max(int(cfg.rerank_m) or 2 * k, k)
        queries = np.ascontiguousarray(queries, np.float32)
        B = queries.shape[0]
        q_dev = self._t(queries)
        ledger = NetLedger(cfg.fabric)
        stats = {"meta_s": 0.0, "sub_s": 0.0, "plan_s": 0.0,
                 "n_rounds": 0, "n_pairs": 0, "quant": cfg.quant,
                 "rerank_m": m}

        if self._flat_kernel_active():
            pool_d, pool_p, plan = self._stage1_flat(q_dev, B, m, ledger,
                                                     stats)
            tiers = self.tiers
        else:
            pool_d, pool_p, plan, tiers = self._stage1_pairs(
                q_dev, B, m, ef, b, qpb, pb, ledger, stats)

        # stage-2 accounting: pool payload -> row fetch plan
        t0 = time.perf_counter()
        if pool_p.is_cuda:
            torch.cuda.synchronize(pool_p.device)
        stats["sub_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        pool_h = pool_p.cpu().numpy()
        live = pool_h[:, :, 1] >= 0
        flat_rows = pool_h[:, :, 1][live]
        flat_pids = pool_h[:, :, 2][live]
        n_admitted = 0
        if cfg.mode == "naive":
            pool.post_row_reads([(int(p), 1) for p in flat_pids],
                                ledger=ledger, doorbell=1)
            stats["rerank_rows"] = int(len(flat_rows))
            stats["rerank_hit_rows"] = 0
        else:
            # query-aware: each needed row moves at most once per batch
            uniq_rows, first = np.unique(flat_rows, return_index=True)
            uniq_pids = flat_pids[first]
            resident = tiers.exact.resident()
            hit = np.isin(uniq_pids, np.fromiter(resident, np.int64,
                                                 len(resident)))
            groups: dict[int, int] = {}
            for p in uniq_pids[~hit].tolist():
                groups[p] = groups.get(p, 0) + 1
            items = sorted(groups.items())
            pool.post_row_reads(
                items, ledger=ledger,
                doorbell=1 if cfg.mode == "no_doorbell" else cfg.doorbell)
            if items:
                ledger.save(pb * len(items)
                            - sum(c for _, c in items) * row_b)
            for p in set(uniq_pids[hit].tolist()):
                tiers.exact.touch(int(p))
            # cost-based admission: a partition whose cumulative missed
            # re-rank rows already outweigh one span fetch is promoted
            for p, cnt in items:
                tiers.note_rerank_miss(int(p), cnt)
                if tiers.should_admit(int(p), row_b, pb):
                    slot, _ = tiers.admit_exact(int(p))
                    g_b, v_b = pool.read_spans(np.array([int(p)]),
                                               ledger=ledger, doorbell=1)
                    DS.write_slots(spec, self._cache_g, self._cache_v,
                                   self._t([slot], torch.int32), g_b, v_b)
                    n_admitted += 1
            stats["rerank_rows"] = int((~hit).sum())
            stats["rerank_hit_rows"] = int(hit.sum())
        dt = time.perf_counter() - t0
        stats["plan_s"] += dt
        TRACER.add("compute.rerank_plan", "compute", t0, dt,
                   admitted=n_admitted)
        stats["exact_admitted"] = n_admitted

        # stage-2 re-rank: exact distances over candidate rows only
        t0 = time.perf_counter()
        with TRACER.span("compute.rerank", tier="compute", m=m):
            vrows = pool.read_rows(pool_p[:, :, 1])
            run_d, run_g = DS.rerank_gathered(vrows, q_dev, pool_p[:, :, 1],
                                              pool_p[:, :, 0], k=k)
            run_d = run_d.cpu().numpy()
        run_g = run_g.cpu().numpy().astype(np.int64)
        stats["sub_s"] += time.perf_counter() - t0

        stats["net"] = ledger.as_dict()
        stats["round_trips_per_query"] = ledger.round_trips / max(B, 1)
        stats["cache_hits"] = plan["n_cache_hits"]
        stats["n_fetches"] = plan["n_fetches"]
        stats["pool"] = pool.snapshot()
        return run_d, run_g, stats

    def _stage1_pairs(self, q_dev, B: int, m: int, ef: int, b: int,
                      qpb: int, pb: int, ledger, stats):
        """Per-pair stage 1: plan against the quantized tier with the round
        machinery and pool per-query top-m candidates through one
        scatter-merge per round (``serve_quant_pool``)."""
        cfg = self.cfg
        pool = self.pool
        spec = pool.spec
        include_graph = cfg.search_mode == "graph"

        t0 = time.perf_counter()
        pids = self._route(q_dev, b)
        stats["meta_s"] = time.perf_counter() - t0
        TRACER.add("compute.route", "compute", t0, stats["meta_s"], B=B)

        # stage-1 plan against the quantized tier.  A quantized span read
        # moves the codes + codebook (and, in graph mode, the adjacency
        # blocks): 2 descriptors per span
        t0 = time.perf_counter()
        if cfg.mode == "naive":
            raw = SCH.naive_plan(pids)
            pool.post_span_reads(len(raw), ledger=ledger, doorbell=1,
                                 quant=True, quant_graph=include_graph,
                                 pids=[p for _, p in raw])
            ledger.save(len(raw) * (pb - qpb))
            uniq = sorted({p for _, p in raw})
            tiers = SCH.TieredCacheState(max(len(uniq), 1), 1)
            plan = SCH.plan_batch(pids, tiers.quant, doorbell=1)
        else:
            tiers = self.tiers
            plan = SCH.plan_batch(pids, tiers.quant, doorbell=cfg.doorbell,
                                  owner_of=getattr(pool, "owner_of_pid",
                                                   None))
        stats["plan_s"] = time.perf_counter() - t0
        TRACER.add("compute.plan", "compute", t0, stats["plan_s"],
                   rounds=len(plan.rounds), fetches=plan.n_fetches,
                   hits=plan.n_cache_hits)

        # stage-1 rounds: fetch quantized spans -> pool candidates
        mt_dev = pool.read_meta()
        pool_d = torch.full((B, m), torch.inf, dtype=torch.float32,
                            device=self.device)
        pool_p = torch.full((B, m, 3), -1, dtype=torch.int32,
                            device=self.device)
        if cfg.mode == "naive":
            slots_q = self._quant_slots(tiers.quant.capacity)
            fetch_ledger = None
            fetch_doorbell = 1
        else:
            slots_q = (self._cache_qg, self._cache_qv, self._cache_qs)
            fetch_ledger = ledger
            fetch_doorbell = 1 if cfg.mode == "no_doorbell" else cfg.doorbell

        for rnd in plan.rounds:
            stats["n_rounds"] += 1
            with TRACER.span("compute.round", tier="compute",
                             fetch=int(len(rnd.fetch_pids)),
                             pairs=int(len(rnd.serve_pairs))):
                if len(rnd.fetch_pids):
                    with TRACER.span("compute.fetch", tier="compute",
                                     spans=int(len(rnd.fetch_pids)),
                                     quant=True):
                        blocks = pool.read_spans(
                            rnd.fetch_pids, ledger=fetch_ledger,
                            doorbell=fetch_doorbell, quant=True,
                            quant_graph=include_graph)
                        if fetch_ledger is not None:
                            ledger.save(len(rnd.fetch_pids) * (pb - qpb))
                        DS.write_slots_quant(spec, *slots_q,
                                             self._t(rnd.fetch_slots),
                                             *blocks)
                if not len(rnd.serve_pairs):
                    continue
                t0 = time.perf_counter()
                n = len(rnd.serve_pairs)
                qi, ppid, pslot, prank, valid = rnd.serve_tensors(
                    pow2_pad(n), B)
                pool_d, pool_p = DS.serve_quant_pool(
                    spec, *slots_q, mt_dev, q_dev, pool_d, pool_p,
                    self._t(qi), self._t(ppid), self._t(pslot),
                    self._t(prank), self._t(valid), m=m, ef=max(ef, m),
                    mode=cfg.search_mode, n_lanes=b)
                dt = time.perf_counter() - t0
                stats["sub_s"] += dt
                TRACER.add("compute.serve", "compute", t0, dt, pairs=n,
                           quant=True)
                stats["n_pairs"] += n
        return pool_d, pool_p, {"n_cache_hits": plan.n_cache_hits,
                                "n_fetches": plan.n_fetches}, tiers

    # ------------------------------------------------ flat stage-1 (kernel)

    def _flat_kernel_active(self) -> bool:
        """The quant_topk route: only for flat (scan) stage 1, and only
        when the quantized tier is dense-resident — it can hold every
        partition, so after one sweep the whole int8 database lives at
        the compute node and stage 1 never touches the wire again."""
        cfg = self.cfg
        return (cfg.quant_kernel != "off" and cfg.search_mode == "scan"
                and self.tiers is not None
                and self.tiers.quant.capacity >= self.pool.spec.n_partitions)

    def _sync_flat(self, ledger) -> None:
        """Populate the dense-resident flat view.  The cold sync charges one
        quantized-span read per partition, doorbell-batched."""
        cfg = self.cfg
        spec = self.pool.spec
        self.pool.post_span_reads(
            spec.n_partitions, ledger=ledger,
            doorbell=1 if cfg.mode in ("naive", "no_doorbell")
            else cfg.doorbell,
            quant=True, quant_graph=False,
            pids=np.arange(spec.n_partitions))
        rows, gids, pids = LA.flat_quant_rows(self.pool.store)
        n = len(rows)
        npad = pow2_pad(max(n, 1), lo=256)
        self._flat_idx = np.full(npad, -1, np.int64)
        self._flat_idx[:n] = rows
        self._flat_gid = np.full(npad, -1, np.int64)
        self._flat_gid[:n] = gids
        self._flat_pid = np.full(npad, -1, np.int64)
        self._flat_pid[:n] = pids
        self._flat_n = n
        # device twins of the payload columns, int32 as in the reference
        self._flat_cols = self._t(np.stack([self._flat_gid, self._flat_idx,
                                            self._flat_pid], axis=-1),
                                  torch.int32)
        self._flat_codes, self._flat_scales = self.pool.read_quant_rows(
            self._t(self._flat_idx, torch.int32))
        # mark every partition resident, as the reference does
        for p in range(spec.n_partitions):
            self.tiers.quant.admit(p)
        self._flat_synced = True

    def _stage1_flat(self, q_dev, B: int, m: int, ledger, stats):
        """Stage 1 as ONE fused int8 scan over the flat dense-resident
        database: ``quant_topk`` — the CUDA kernel for tensors on the card
        under ``quant_kernel="auto"``, the plain torch version under
        "ref" and for tensors on the CPU.  No meta routing, no rounds."""
        from repro_torch.kernels.quant_topk.ops import quant_topk

        cfg = self.cfg
        use_ref = cfg.quant_kernel == "ref"
        t0 = time.perf_counter()
        cold = not self._flat_synced
        if cold:
            with TRACER.span("compute.flat_sync", tier="compute"):
                self._sync_flat(ledger)
            ledger.save(self.pool.spec.n_partitions
                        * (self.pool.spec.partition_bytes()
                           - self.pool.spec.quant_partition_bytes(
                               include_graph=False)))
        stats["plan_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with TRACER.span("compute.stage1_flat", tier="compute",
                         rows=int(self._flat_n), B=B):
            d, idx = quant_topk(q_dev, self._flat_codes, self._flat_scales,
                                min(m, self._flat_n), cfg.quant_group,
                                n_valid=self._flat_n, use_ref=use_ref)
        live = idx >= 0
        cols = self._flat_cols[idx.long().clamp(min=0)]      # (B, k', 3)
        pool_p = torch.where(live[:, :, None], cols, -1)
        pool_d = torch.where(live, d, torch.inf)
        if pool_d.shape[1] < m:           # flat DB smaller than the pool
            pad = m - pool_d.shape[1]
            pool_d = torch.cat([pool_d, pool_d.new_full((B, pad),
                                                        torch.inf)], 1)
            pool_p = torch.cat([pool_p, pool_p.new_full((B, pad, 3), -1)], 1)
        stats["sub_s"] += time.perf_counter() - t0
        stats["n_rounds"] = 1
        stats["n_pairs"] = B
        stats["quant_kernel"] = "flat"
        stats["stage1_impl"] = ("ref" if use_ref or not q_dev.is_cuda
                                else "cuda")
        stats["flat_rows"] = int(self._flat_n)
        return pool_d, pool_p, {
            "n_cache_hits": 0 if cold else B,
            "n_fetches": self.pool.spec.n_partitions if cold else 0}

    # ------------------------------------------------------------ insert

    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Dynamic insertion (paper §3.2): route via the cached meta-HNSW,
        append vector+id into the target group's shared overflow region
        through the pool ``append`` verb (one remote WRITE each), repack
        the group when it fills."""
        cfg = self.cfg
        pool = self.pool
        spec = pool.spec
        vecs = np.asarray(vecs, np.float32).reshape(-1, spec.dim)
        t0 = time.perf_counter()
        pids = self._route(self._t(vecs), b=1)[:, 0]
        TRACER.add("compute.route", "compute", t0,
                   time.perf_counter() - t0, B=int(len(vecs)))
        gids = np.arange(self._n0 + len(self._extra),
                         self._n0 + len(self._extra) + len(vecs))
        ledger = NetLedger(cfg.fabric)
        for vec, gid, pid in zip(vecs, gids, pids.tolist()):
            self._extra[int(gid)] = vec
            self._extra_pid[int(gid)] = int(pid)
            slot = pool.append(vec, int(gid), int(pid), ledger=ledger)
            if slot < 0:
                group = int(pool.store.meta_table[pid, LA.MT_GROUP])
                ok = pool.repack(group, self._lookup)
                if not ok:
                    # the full rebuild folds _extra — INCLUDING this
                    # vector — into the rebuilt base partitions, so
                    # appending it again would duplicate its gid
                    self._full_rebuild()
                    continue
                self._invalidate_group(group)
                # re-stage through the pool append verb, which performs
                # the device and quantized-mirror twin writes
                slot = pool.append(vec, int(gid), int(pid), ledger=ledger)
                assert slot >= 0, "overflow full right after repack"
                self._flat_synced = False   # repack moved base rows
                continue
            self._invalidate_pid(int(pid))
            if self._flat_synced:
                self._append_flat(int(gid), int(pid))
        self._last_insert_net = ledger.as_dict()
        return gids

    def _append_flat(self, gid: int, pid: int):
        """Keep the dense-resident flat view coherent with one append:
        the writer already holds the row (it produced the WRITE), so
        this is pure compute-side bookkeeping — no wire traffic.  Row n
        of the codes, the scales and the payload twin ``_flat_cols`` is
        written in place."""
        n = self._flat_n
        if n >= len(self._flat_idx):
            self._flat_synced = False        # outgrew the pad: resync
            return
        mrow = self.pool.store.meta_table[pid]
        side = int(mrow[LA.MT_SIDE])
        cnt = int(mrow[LA.MT_OV_A if side == 0 else LA.MT_OV_B])
        slot = cnt - 1 if side == 0 else self.pool.spec.ov_cap - cnt
        group = int(mrow[LA.MT_GROUP])
        co = LA.overflow_write_coords(self.pool.spec, group, slot)
        row = (co["vec_block"] * self.pool.spec.slot_vecs
               + co["vec_off"] // self.pool.spec.dim)
        self._flat_idx[n] = row
        self._flat_gid[n] = gid
        self._flat_pid[n] = pid
        self._flat_n = n + 1
        # only row n changed: a one-row gather and in-place writes, so a
        # flat-route insert stays O(D), not O(N*D)
        codes, scales = self.pool.read_quant_rows(
            self._t([row], torch.int32))
        self._flat_codes[n] = codes[0]
        self._flat_scales[n] = scales[0]
        self._flat_cols[n] = self._t([gid, row, pid], torch.int32)

    def _invalidate_pid(self, pid: int):
        """Drop stale cached copies (both partners see the ov region)."""
        group = int(self.pool.store.meta_table[pid, LA.MT_GROUP])
        self._invalidate_group(group)

    def _invalidate_group(self, group: int):
        for side in (0, 1):
            p = group * 2 + side
            if self.tiers is not None:
                self.tiers.invalidate(p)    # drops BOTH tiers
            self.cache.drop(p)

    def _full_rebuild(self):
        """np_max exhausted: rebuild the whole region with a larger pad
        (rare; the paper's offline re-pack path)."""
        data = np.concatenate([self._data, np.stack(
            [self._extra[g] for g in sorted(self._extra)])]) \
            if self._extra else self._data
        assigns = np.concatenate([
            self.meta.assignments,
            np.array([self._extra_pid[g] for g in sorted(self._extra)],
                     np.int32)])
        import dataclasses as DC
        self.meta = DC.replace(self.meta, assignments=assigns)
        self._data = data
        self._n0 = data.shape[0]
        self._extra.clear()
        self._extra_pid.clear()
        old_spec = self.pool.spec
        store = LA.build_store(
            data, self.meta, ov_cap=old_spec.ov_cap,
            slot_vecs=old_spec.slot_vecs,
            sub_params=HNSWParams(M=max(self.cfg.sub_M0 // 2, 2),
                                  M0=self.cfg.sub_M0,
                                  ef_construction=self.cfg.ef_construction))
        self.pool.adopt(store)
        if self.tiers is not None:
            self._setup_quant(self._cap0)
        else:
            cap = self.cache.capacity
            self._setup_caches(cap)
        self._flat_synced = False

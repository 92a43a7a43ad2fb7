"""Batched d-HNSW search in a closed loop: the paper's system through the
port's entry, ``repro_torch.core.engine.DHNSWEngine.search``.

One client sends the next batch of B queries as soon as the previous
batch's results are on the host (the call ends in a host read, so the
device has finished).  Batches take the traffic mix's query pool in order
and cycle through it; the engine's partition cache carries over from batch
to batch.  A query's latency is its batch's wall time.

Set-up: the data and the query pool from the seed, the index through the
program's own ``DHNSWEngine.build``, the kernels loaded at their first
launch, then ``warmup_batches`` batches.  After the window the program is
freed and the plain reference judges every answer the window produced.

In a traced run the runner also notes which partitions each batch's exact
span reads fetched (the pool's ``read_spans`` wrapped on the instance),
so that the fetch layer's roofline counts the rows those partitions hold.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.reference import exact_knn as REF
from bench.yardstick import check, data as D, net, stats as ST

FABRICS = ("rdma-100g",)


class Runner:
    """One run of one cell.  ``search`` (optional) stands in for the
    program: ``search(data, device)`` gives a callable ``(queries (B, D)
    f32, k) -> (dists, ids, stats)``, as the control uses it; ``wrap``
    (optional) wraps the program's ``search``, as the fault tests use
    it.  ``trace``: note the partitions each batch fetches."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 *, search=None, wrap=None, trace: bool = False):
        self.config, self.traffic = config, traffic
        self.seed = seed
        self.device = torch.device(device)
        self.k = int(config["k"])
        self.batch = int(traffic["batch"])
        self._stand_in, self._wrap = search, wrap
        self._search = None
        self.engine = None
        self._trace = trace
        self._fetched = []

    # --------------------------------------------------------------- setup

    def setup(self) -> None:
        self.data, self.queries = D.make(self.config, self.traffic,
                                         self.seed)
        if self._stand_in is not None:
            self._search = self._stand_in(self.data, self.device)
        else:
            self.engine = self._build()
            self._search = self.engine.search
            if self._trace:
                self._note_fetches(self.engine.pool)
        if self._wrap is not None:
            self._search = self._wrap(self._search)
        self.next_batch = 0
        for _ in range(int(self.traffic["warmup_batches"])):
            self._one()
        self._fetched = []

    def _build(self):
        from repro_torch.core.cost_model import RDMA_100G
        from repro_torch.core.engine import DHNSWEngine, EngineConfig
        kw = dict(self.config["engine"])
        if kw.pop("fabric") not in FABRICS:
            raise ValueError(f"fabric not in {FABRICS}")
        cfg = EngineConfig(fabric=RDMA_100G, **kw)
        return DHNSWEngine(cfg, device=self.device).build(self.data)

    def _note_fetches(self, pool) -> None:
        """Wrap the pool's ``read_spans`` on this instance: every exact
        span read appends the partitions it fetched."""
        read_spans = pool.read_spans

        def noted(pids, **kw):
            if not kw.get("quant"):
                self._fetched.append(np.asarray(pids).reshape(-1).copy())
            return read_spans(pids, **kw)
        pool.read_spans = noted

    def layout(self) -> dict:
        """Shape numbers of the built index, for the roofline readers.
        ``partition_bytes``: the bytes that partition p's rows hold in
        the region, (P,): each base row's graph entry (``deg`` neighbours
        and its global id, int32) and vector (float32), and each overflow
        row in use in its group (global id and vector)."""
        if self.engine is None:
            return {}
        from repro_torch.core import layout as LA
        pool, cfg = self.engine.pool, self.engine.cfg
        spec = pool.spec
        mt = np.asarray(pool.store.meta_table, dtype=np.int64)
        n_base = mt[:, LA.MT_N_BASE]
        n_over = mt[:, LA.MT_OV_A] + mt[:, LA.MT_OV_B]
        row = spec.dim * 4
        return {"dim": spec.dim,
                "partition_bytes": (n_base * ((spec.deg + 1) * 4 + row)
                                    + n_over * (4 + row)),
                "quant_group": cfg.quant_group if cfg.quant == "int8" else 0,
                "rerank_m": max(int(cfg.rerank_m) or 2 * self.k, self.k)}

    # -------------------------------------------------------------- window

    def _qidx(self, i: int) -> np.ndarray:
        pool = self.queries.shape[0]
        return (i * self.batch + np.arange(self.batch)) % pool

    def _one(self):
        qi = self._qidx(self.next_batch)
        self.next_batch += 1
        t0 = time.perf_counter()
        d, g, st = self._search(self.queries[qi], self.k)
        return qi, d, g, st, time.perf_counter() - t0

    def window(self, seconds: float, profiler) -> dict:
        """Batches until ``seconds`` have passed.  ``profiler.tick`` runs
        between batches.  Returns the batches and every answer."""
        batches, answers = [], []
        t0 = time.perf_counter()
        elapsed = 0.0
        while True:
            profiler.tick(elapsed)
            profiled = profiler.active
            qi, d, g, st, wall = self._one()
            answers.append((qi, d, g))
            batches.append({"wall_s": wall, "n": len(qi), "stats": st,
                            "profiled": profiled,
                            "fetched": self._fetched})
            self._fetched = []
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        profiler.close()
        return {"batches": batches, "answers": answers, "window_s": elapsed}

    # --------------------------------------------------------------- after

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.engine = None
        self._search = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, answers: list) -> dict:
        x = REF.to_device(self.data, self.device)
        qs = REF.to_device(self.queries, self.device)
        _, gt = REF.exact_topk(x, qs, self.k)
        del x, qs
        return check.judge(answers, self.data, self.queries, gt, k=self.k,
                           limits=self.config["limits"], device=self.device)

    def end_to_end(self, res: dict, verdict: dict) -> dict:
        """The end-to-end metrics this runner measures (without
        ``setup_s``), by name: value and unit."""
        b = res["batches"]
        n = sum(x["n"] for x in b)
        out = {
            "qps": (n / res["window_s"], "queries/s"),
            "p95_ms": (1e3 * ST.weighted_percentile(
                [x["wall_s"] for x in b], [x["n"] for x in b], 95),
                "ms"),
            "recall_at_10": (verdict["recall_at_10"], "fraction"),
        }
        nets = [x["stats"]["net"] for x in b if "net" in x["stats"]]
        if nets:
            out["net_us_per_query"] = (net.us_per_query(nets, n),
                                       "us/query")
        return out


def reference_search(data: np.ndarray, device):
    """The control put in the program's place: the reference's search in
    bfloat16 over the benchmark's data."""
    x = REF.to_device(data, device)

    def search(queries, k):
        q = REF.to_device(queries, device)
        d, g = REF.bf16_topk(x, q, k)
        return d.cpu().numpy(), g.cpu().numpy(), {}
    return search


def half_rows_search(data: np.ndarray, device):
    """A planted fault in the program's place: the exact search over a
    fixed random half of the rows.  Every answer keeps the stated
    guarantees (valid, distinct ids, sorted, each with its exact
    distance), but about half of the true neighbours are missing: what a
    stale cache slot, a skipped partition or a cut-short beam returns."""
    keep = np.sort(D.rng_for(0).permutation(len(data))[:len(data) // 2])
    x = REF.to_device(data[keep], device)
    keep_t = torch.as_tensor(keep, device=device)

    def search(queries, k):
        q = REF.to_device(queries, device)
        d, g = REF.exact_topk(x, q, k)
        return d.float().cpu().numpy(), keep_t[g].cpu().numpy(), {}
    return search


control = reference_search
faults = {"half_rows": half_rows_search}

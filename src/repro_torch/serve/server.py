"""Serving front-end: one ``DHNSWEngine`` behind a ``MicroBatcher``.

``SearchServer`` is the process-level object a deployment embeds: it owns
the engine and the batching policy, exposes blocking and async
search/insert, and reports rolling service metrics (throughput,
p50/p95/p99, stage breakdown).  Many client threads may call it
concurrently; all engine access is serialized through the batcher's
dispatcher thread, which is also what makes concurrent requests fuse
into the paper's batched query-aware loads.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.core.engine import DHNSWEngine
from repro_torch.serve.batcher import BatchPolicy, MicroBatcher


class SearchServer:
    """build-or-adopt an engine -> ``with SearchServer(eng) as srv: ...``."""

    def __init__(self, engine: DHNSWEngine,
                 policy: Optional[BatchPolicy] = None, *,
                 autostart: bool = True):
        self.engine = engine
        self.batcher = MicroBatcher(engine, policy, autostart=autostart)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SearchServer":
        self.batcher.start()
        return self

    def stop(self):
        self.batcher.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ requests

    def search(self, vecs: np.ndarray, k: int = 10, *, tenant: str = "-"):
        """Blocking: (dists (m, k), gids (m, k), per-request stats)."""
        return self.batcher.search(vecs, k, tenant=tenant)

    def search_async(self, vecs: np.ndarray, k: int = 10, *,
                     tenant: str = "-") -> Future:
        return self.batcher.submit_search(vecs, k, tenant=tenant)

    def insert(self, vecs: np.ndarray, *, tenant: str = "-") -> np.ndarray:
        return self.batcher.insert(vecs, tenant=tenant)

    def insert_async(self, vecs: np.ndarray, *,
                     tenant: str = "-") -> Future:
        return self.batcher.submit_insert(vecs, tenant=tenant)

    # ------------------------------------------------------------ metrics

    def stats(self) -> dict:
        """Rolling service metrics (the /stats endpoint payload):
        request/latency percentiles, stage breakdown, the NetLedger
        roll-up under ``net`` — bytes_fetched / bytes_saved (nonzero
        when the engine serves through the quantized tier), round trips
        and doorbell descriptors across all fused calls — the
        per-tenant view under ``tenants`` (admit/reject counts, live
        queue depth, served rows + fair-queue ``share`` per tenant
        key), and under ``pool`` the latest memory-pool snapshot (verb
        totals; per-shard breakdown + migration counters when serving
        through a ``ShardedPool``)."""
        return self.batcher.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`stats` — SLO burn rates,
        per-(verb, shard) pool latency histograms, straggler verdicts,
        and tracer-health gauges included — plus per-span duration
        histograms when the tracer is enabled."""
        from repro_torch.obs.metrics import render_prometheus
        from repro_torch.obs.trace import TRACER
        spans = TRACER.snapshot() if TRACER.enabled else None
        return render_prometheus(self.stats(), spans, tracer=TRACER)

    def dump_trace(self, path) -> int:
        """Harvest server-side spans (remote pools) and write the whole
        trace as Chrome-trace JSON.  Returns the span count written."""
        from repro_torch.obs.trace import TRACER
        pool = self.engine.pool
        if TRACER.enabled and hasattr(pool, "harvest_trace"):
            from repro_torch.pool.protocol import PoolUnavailableError
            try:
                pool.harvest_trace()
            except PoolUnavailableError:
                pass
        return TRACER.save(path)

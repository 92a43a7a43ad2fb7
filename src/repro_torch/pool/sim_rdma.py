"""Simulated-RDMA memory pool: LocalPool's data path + a modeled NIC.

Port of ``repro/pool/sim_rdma.py``.  The container has no fabric, so —
exactly like the paper's latency *breakdown* methodology — the transport
is simulated: every charged verb advances a per-verb simulated clock by

    trips * rtt  +  descriptors * per_op  +  bytes / bandwidth

using a ``Fabric`` calibration (defaults to the paper's ConnectX-6
testbed, ``RDMA_100G``).  Results are bit-identical to ``LocalPool`` —
the data movement is the same device gathers — but search stats carry a
nonzero modeled network latency with a per-verb breakdown, so benchmark
numbers reflect round trips and wire time rather than event counts
alone.  ``benchmarks/torch_pool.py`` sweeps the fabric parameters.

Fan-out semantics: ``_transport`` accepts either scalars (one
destination — the single-node case, bit-identical to before) or
per-destination sequences.  With ``parallel=True`` a multi-destination
charge is reduced by ``max`` (destinations answer their doorbell
batches concurrently, so the critical path is the slowest slice);
serial mode sums.  ``fanout_dt`` is the shared reduction —
``ShardedPool`` uses it to aggregate its children's modeled clocks the
same way.

Optionally (``sleep=True``) the pool also *injects* the modeled latency
as real wall time — useful to make the serving tier feel remote reads in
end-to-end latency percentiles; off by default so tests stay fast.
Every modeled charge slice is also *issued* through a
:class:`repro_torch.rdma.verbs.QueuePair` over the accounting-only
``ModelBearer``: one ``post_send`` per modeled round trip, one
``WorkRequest`` per descriptor.  The bearer carries no bytes and the
clock is still priced from the aggregate slice (so ``sim_s`` stays
bit-identical to the pre-verbs math), but the doorbell/descriptor
structure of the simulated fabric now flows through the same QP
interface the real bearers use — ``snapshot()["qp"]`` reports the
tallies.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import RDMA_100G, Fabric
from repro_torch.core.layout import Store
from repro_torch.pool.local import LocalPool
from repro_torch.rdma import verbs as V
from repro_torch.rdma.loopback import ModelBearer

Slices = Union[float, int, Sequence[float]]


def fanout_dt(dts: Sequence[float], parallel: bool) -> float:
    """Reduce per-destination modeled times: concurrent destinations
    cost the max (critical path), serial destinations the sum."""
    dts = list(dts)
    if not dts:
        return 0.0
    return max(dts) if parallel else float(sum(dts))


class SimulatedRDMAPool(LocalPool):
    """LocalPool + a per-verb latency/bandwidth model: every charge
    slice is priced on this node's ``Fabric`` into ``sim_s``."""

    kind = "sim_rdma"

    def __init__(self, store: Store, *, device,
                 fabric: Optional[Fabric] = None,
                 use_gather_kernel: bool = False, sleep: bool = False,
                 parallel: bool = False):
        self.fabric = fabric or RDMA_100G
        self.sleep = sleep
        self.parallel = parallel
        self.sim_s: dict[str, float] = {}      # per-verb modeled seconds
        # the simulated NIC: every charge slice posts its descriptor
        # structure through this QP (accounting only, no bytes move)
        self._qp = V.QueuePair(ModelBearer())
        super().__init__(store, device=device,
                         use_gather_kernel=use_gather_kernel)

    def _post_slice(self, n_bytes: float, descriptors: float,
                    trips: float) -> None:
        """Issue one charge slice as WR lists: ``trips`` doorbell
        batches carrying ``descriptors`` READ WRs between them (the
        first batch also names the slice's bytes).  Completions are
        polled immediately — the model bearer is synchronous."""
        t = max(int(trips), 1) if trips else 0
        if t == 0:
            return
        d = max(int(descriptors), t)
        base, extra = divmod(d, t)
        for i in range(t):
            n = base + (1 if i < extra else 0)
            wrs = [V.WorkRequest(V.READ, rkey=V.RKEY_SPANS,
                                 length=int(n_bytes) if i == 0 and k == 0
                                 else 0)
                   for k in range(n)]
            self._qp.post_send(wrs)
        self._qp.cq.poll(t)

    def model_dt(self, n_bytes: float, descriptors: float,
                 trips: float) -> float:
        """Modeled seconds of one charge slice on this node's fabric."""
        f = self.fabric
        return (trips * f.rtt_s + descriptors * f.per_op_s
                + n_bytes / f.bw_Bps)

    def set_injector(self, injector) -> None:
        """Attach (or with None, detach) a WR-level fault injector to the
        simulated NIC's bearer; see :mod:`repro_torch.rdma.inject`.  Injected
        latency lands in the *observed* clock (``sim_s``, histograms)
        but never in :meth:`model_dt` — the a-priori cost model stays
        honest and only the straggler detector can route around it."""
        self._qp.bearer.injector = injector

    def _transport(self, verb: str, n_bytes: Slices, descriptors: Slices,
                   trips: Slices) -> float:
        b = np.atleast_1d(np.asarray(n_bytes, np.float64))
        d = np.atleast_1d(np.asarray(descriptors, np.float64))
        t = np.atleast_1d(np.asarray(trips, np.float64))
        inj = getattr(self._qp.bearer, "injector", None)
        inj0 = inj.injected_s if inj is not None else 0.0
        for bi, di, ti in zip(b, d, t):
            self._post_slice(bi, di, ti)
        # the clock is priced from the aggregate slice (not summed over
        # WR lists) so the float math is bit-identical to the pre-QP
        # accounting; WR-injected delay (chaos) adds on top
        dt = fanout_dt([self.model_dt(bi, di, ti)
                        for bi, di, ti in zip(b, d, t)],
                       self.parallel and len(b) > 1)
        if inj is not None:
            dt += inj.injected_s - inj0
        self.sim_s[verb] = self.sim_s.get(verb, 0.0) + dt
        if self.sleep:
            time.sleep(dt)
        return dt

    @property
    def sim_total_s(self) -> float:
        """Total modeled wire seconds across all verbs."""
        return sum(self.sim_s.values())

    def snapshot(self) -> dict:
        """See ``MemoryPool.snapshot``; adds fabric calibration and the
        per-verb modeled-seconds breakdown."""
        out = super().snapshot()
        # full fabric calibration, not just the name: benchmark rows
        # built from this snapshot are self-describing
        out["fabric"] = fabric_params(self.fabric)
        out["sim_s"] = dict(self.sim_s)
        out["sim_total_s"] = self.sim_total_s
        out["qp"] = self._qp.bearer.snapshot()
        return out


def fabric_params(f: Fabric) -> dict:
    """The parameters the latency model prices with, JSON-ready."""
    return {"name": f.name, "rtt_us": f.rtt_s * 1e6,
            "bw_GBps": f.bw_Bps / 1e9, "per_op_us": f.per_op_s * 1e6,
            "max_doorbell": f.max_doorbell}

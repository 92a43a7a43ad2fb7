"""The compute/memory boundary — the paper's disaggregation, as an API.

Port of ``repro/pool/protocol.py``.  d-HNSW's architecture is a *compute
pool* that plans greedy search and a *memory pool* reached over one-sided
RDMA verbs.  Everything a compute node may do to the memory pool is one
of the verbs below; everything else (the cached meta-HNSW, the resident
partition caches, the round scheduler, the device serve path) lives on
the compute side (``pool/compute.py ComputeClient``).

Verb accounting: data verbs take an optional ``NetLedger`` and charge it
in doorbell batches exactly the way the schemes demand — ``doorbell=1``
is the no-doorbell scheme (every span/row group its own round trip),
``doorbell=n`` groups n descriptors per trip, and the ``post_*`` verbs
charge without moving data (the naive scheme reads the same span once
per demanding query; the simulation dedups the movement but must not
dedup the charge).  ``ledger=None`` moves data without charging.  Pools
keep running totals (``totals``) and per-verb invocation counts
(``verbs``) beside the ledgers.

Transports that model or measure a wire hook ``_transport``: the slice
it returns is recorded into the per-(verb, shard) latency histograms
(``hist``) the straggler detector reads.  The port has the in-process
(``LocalPool``), simulated-RDMA (``SimulatedRDMAPool``), sharded
(``ShardedPool``) and remote (``repro_torch.net.RemotePool``) transports.
"""
from __future__ import annotations

import abc
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import NetLedger
from repro_torch.core.layout import LayoutSpec, Store
from repro_torch.core.scheduler import doorbell_chunks
from repro_torch.obs.trace import TRACER


class PoolUnavailableError(ConnectionError):
    """A memory node cannot be reached (dead, unreachable, or timed out).

    Raised by transports instead of hanging on a vanished node.  Callers
    that hold replicas (``ShardedPool`` with ``replication >= 2``) catch
    it, mark the shard dead, and retry on a surviving replica; everyone
    else surfaces it.
    """


class MemoryPool(abc.ABC):
    """Abstract memory-pool transport.

    Concrete pools own the serialized region (``Store`` host staging plus
    the transport's device representation) and implement the verbs.
    ``spec`` is always ``store.spec``.  The charge rule and the
    pure-accounting ``post_*`` verbs live HERE, shared by every transport,
    so ledger parity has exactly one copy to hold to.
    """

    kind: str = "abstract"
    store: Store
    device: torch.device

    # ------------------------------------------------------------ meta

    @property
    def spec(self) -> LayoutSpec:
        """The region's frozen ``LayoutSpec`` (= ``store.spec``)."""
        return self.store.spec

    def read_meta(self):
        """Device copy of the global metadata table (per-partition
        offsets/counters).  Compute instances cache it — the paper's
        'global metadata block' — so this verb is never charged; it is
        restaged lazily after writes move the host counters."""
        self.verbs["read_meta"] += 1
        if self._mt_dirty:
            with TRACER.wait("upload"):
                self._mt_dev = torch.as_tensor(self.store.meta_table,
                                               device=self.device)
            self._mt_dirty = False
        return self._mt_dev

    @abc.abstractmethod
    def adopt(self, store: Store) -> None:
        """Re-register a rebuilt region (the offline full re-pack)."""

    @abc.abstractmethod
    def attach_quant(self, group: int) -> None:
        """Attach (or rebuild) the int8 + codebook mirror of the region
        and stage it for quantized reads."""

    # ------------------------------------------------------------ reads

    @abc.abstractmethod
    def read_spans(self, pids, *, ledger: Optional[NetLedger],
                   doorbell: int = 1, quant: bool = False,
                   quant_graph: bool = True):
        """Doorbell-batched span READ: one descriptor per partition span
        (two for quantized spans — data + appended codebook).  Returns
        device blocks ``(g, v)`` with shape (m, fetch_blocks, ·), or
        ``(g, qv, qs)`` when ``quant``.  Charges ``ledger`` one round trip
        per ``doorbell`` spans."""

    @abc.abstractmethod
    def read_rows(self, rows):
        """Row-granular READ: exact f32 vector rows by region row address
        (-1 lanes are placeholders, masked by the caller).  Accounting is
        posted separately via ``post_row_reads``."""

    @abc.abstractmethod
    def read_quant_rows(self, rows):
        """Row-granular READ from the quantized mirror: (codes, scales)
        for the dense-resident flat-scan path."""

    # ------------------------------------------------------------ charging

    def _transport(self, verb: str, n_bytes, descriptors, trips):
        """Transport hook, called once per charge with the slice it
        carried.  Default: bytes move over nothing (returns None).
        Transports that model a wire return the slice's observed seconds,
        which ``_charge`` records into the per-(verb, shard) latency
        histogram (:meth:`hist`).  Each argument may be a scalar (one
        destination) or a per-destination sequence (a sharded fan-out);
        see ``SimulatedRDMAPool``."""
        return None

    @property
    def hist(self):
        """Lazy per-(verb, shard) latency histogram view.  ``shard_id``
        (set by ``ShardedPool`` on its children; defaults to 0) keys the
        shard dimension."""
        h = getattr(self, "_hist", None)
        if h is None:
            from repro_torch.obs.hist import VerbShardHist
            h = self._hist = VerbShardHist()
        return h

    def _observe(self, verb: str, seconds: float) -> None:
        """Record one observed-latency sample for ``verb`` on this pool's
        shard into :meth:`hist`."""
        self.hist.record(verb, getattr(self, "shard_id", 0), seconds)

    def _charge(self, verb: str, ledger: Optional[NetLedger],
                n_bytes: float, descriptors: int) -> None:
        """THE charge rule: ledger + pool running totals + the
        trips = ceil(descriptors / max_doorbell) split."""
        if ledger is None:
            return
        ledger.read(n_bytes, descriptors=descriptors)
        trips = math.ceil(descriptors / ledger.fabric.max_doorbell)
        self.totals["round_trips"] += trips
        self.totals["descriptors"] += descriptors
        self.totals["bytes"] += n_bytes
        dt = self._transport(verb, n_bytes, descriptors, trips)
        if dt is not None:
            self._observe(verb, float(dt))
        if TRACER.enabled:
            TRACER.event("pool." + verb, tier="pool", kind=self.kind,
                         bytes=float(n_bytes), descs=int(descriptors),
                         trips=int(trips))

    def _charge_write(self, verb: str, ledger: Optional[NetLedger],
                      n_bytes: float) -> None:
        """The write-side twin of ``_charge``: one descriptor, one trip."""
        if ledger is None:
            return
        ledger.write(n_bytes, descriptors=1)
        self.totals["round_trips"] += 1
        self.totals["descriptors"] += 1
        self.totals["bytes"] += n_bytes
        dt = self._transport(verb, n_bytes, 1, 1)
        if dt is not None:
            self._observe(verb, float(dt))
        if TRACER.enabled:
            TRACER.event("pool." + verb, tier="pool", kind=self.kind,
                         bytes=float(n_bytes), descs=1, trips=1)

    # ------------------------------------------------- accounting posts

    def post_span_reads(self, n: int, *, ledger: NetLedger,
                        doorbell: int = 1, quant: bool = False,
                        quant_graph: bool = True, pids=None) -> None:
        """Charge ``n`` span READs without moving data (naive scheme:
        every (query, partition) demand is its own read; the flat
        resident sweep: spans already moved by a data verb).  ``pids``
        names the spans for multi-node pools; a single node ignores it."""
        self.verbs["post_span_reads"] += n
        per_bytes, per_desc = span_wire_bytes(self.spec, quant=quant,
                                              quant_graph=quant_graph)
        for db in doorbell_chunks(np.arange(n), doorbell):
            self._charge("post_span_reads", ledger, len(db) * per_bytes,
                         per_desc * len(db))

    def post_row_reads(self, groups, *, ledger: NetLedger,
                       doorbell: int = 1) -> None:
        """Charge row-granular READs.  ``groups`` is [(pid, n_rows)]; each
        group is one descriptor batch member, ``doorbell`` groups per
        round trip."""
        row_b = self.spec.row_bytes()
        groups = list(groups)
        self.verbs["post_row_reads"] += len(groups)
        for chunk in doorbell_chunks(groups, doorbell):
            cnt = sum(c for _, c in chunk)
            self._charge("post_row_reads", ledger, cnt * row_b, cnt)

    # ------------------------------------------------------------ mutation

    def register_mutation_hook(self, fn) -> None:
        """Subscribe ``fn(verb, **info)`` to state-mutating verbs.

        Transports call :meth:`_notify_mutation` after an ``append`` or
        ``repack`` lands; the ingest compactor uses this to track dirty
        groups without polling, and tests use it to observe write flow.
        Hooks run synchronously on the mutating thread and must be
        cheap; a hook must never call back into the pool.
        """
        if not hasattr(self, "_mutation_hooks"):
            self._mutation_hooks = []
        self._mutation_hooks.append(fn)

    def _notify_mutation(self, verb: str, **info) -> None:
        """Fan a landed mutation out to the registered hooks."""
        for fn in getattr(self, "_mutation_hooks", ()):
            fn(verb, **info)

    # ------------------------------------------------------------ writes

    @abc.abstractmethod
    def append(self, vec, gid: int, pid: int, *,
               ledger: Optional[NetLedger]) -> int:
        """One-sided WRITE: stage one vector into ``pid``'s shared
        overflow region — host layout, device twin, and (when attached)
        the quantized-mirror twin, atomically.  Returns the slot index
        or -1 when the group's region is full (caller must repack).
        Charges the wire bytes of the write (vector + id, plus codes +
        codebook scales when the mirror is attached)."""

    @abc.abstractmethod
    def repack(self, group: int, data_lookup) -> bool:
        """Offline re-pack of one group (paper §3.2): fold both
        partners' overflow into rebuilt sub-HNSWs, refresh the quantized
        mirror, re-register the touched region.  Returns False when a
        merged partition no longer fits (caller must full-rebuild)."""

    # ------------------------------------------------------------ stats

    def snapshot(self) -> dict:
        """Verb counts + charged totals (+ transport-specific extras)."""
        out = {"kind": self.kind, "verbs": dict(self.verbs),
               "totals": dict(self.totals)}
        h = getattr(self, "_hist", None)
        if h is not None and len(h):
            out["hist"] = h.to_dict()
        return out


def _fresh_totals() -> dict:
    return {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}


def span_wire_bytes(spec: LayoutSpec, *, quant: bool,
                    quant_graph: bool = True) -> tuple[int, int]:
    """(bytes, descriptors) of ONE span read under the given precision —
    the single pricing rule every pool and every scheme shares."""
    if quant:
        return spec.quant_partition_bytes(include_graph=quant_graph), 2
    return spec.partition_bytes(), 1

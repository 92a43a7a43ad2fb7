"""Out-of-core bulk loading: build the region with O(chunk) builder RAM.

The in-memory build (``ComputeClient.build``) holds the whole dataset
while it samples representatives, assigns every vector, and serializes
every partition.  ``BulkLoader`` produces a **bit-identical** meta +
region from a stream of bounded chunks instead:

* **pass 1 (parse -> validate -> spill)**: each chunk is parsed to
  float32, validated (rank/width/finiteness), and appended to a disk
  spill file; chunks that fail land in a retryable error queue
  (``error_queue`` / :meth:`retry_failed`) instead of aborting the load.
* **pass 2 (finalize)**: representative ids need only ``n`` (the
  sampling is by index — ``meta.rep_sample_ids``), so the rep rows are
  gathered from the spill; assignment is per-row nearest-rep and
  streams chunk-by-chunk; partitions are then serialized one at a time
  from spill gathers (``layout.plan_spec`` guarantees the identical
  region geometry the in-memory build would plan).

The builder working set — one chunk, the rep rows, one chunk's distance
matrix, one partition's staging gather — is tracked by the loader's own
accounting (``LoadReport.peak_builder_bytes``); the region itself is
the *memory pool's* state, not the builder's, and can be shipped
group-by-group to a live pool through the existing ``refresh_blocks``
verb (``finalize(into_pool=...)``).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import layout as LA
from repro_torch.core import meta as ME
from repro_torch.core.hnsw import HNSWParams, brute_force_knn
from repro_torch.obs.trace import TRACER


def chunked_source(data: np.ndarray, chunk_rows: int) -> Iterator[np.ndarray]:
    """Yield ``data`` in row chunks of at most ``chunk_rows``."""
    for s in range(0, len(data), chunk_rows):
        yield data[s:s + chunk_rows]


@dataclass
class FailedChunk:
    """One rejected source chunk, kept for a later retry."""

    index: int          # arrival index of the chunk
    reason: str
    chunk: object       # the raw object as received
    retries: int = 0


@dataclass
class LoadReport:
    """What a bulk load did, with the builder-memory accounting."""

    rows: int = 0
    dim: int = 0
    chunks_total: int = 0
    chunks_ok: int = 0
    chunks_failed: int = 0
    chunks_retried: int = 0
    chunk_rows: int = 0
    chunk_bytes: int = 0            # the configured budget, in bytes
    dataset_bytes: int = 0
    peak_builder_bytes: int = 0     # max simultaneous builder buffers
    verbs_issued: int = 0           # refresh_blocks verbs shipped
    groups_shipped: int = 0
    spill_path: str = ""
    failures: List[Tuple[int, str]] = field(default_factory=list)


class BulkLoader:
    """Streaming two-pass builder for the d-HNSW region.

    Parameters mirror the engine's build knobs (``n_rep``, ``seed``,
    ``meta_levels``, ``sub_params``) so ``finalize()`` reproduces
    ``build_meta`` + ``build_store`` exactly; ``chunk_rows`` is the
    bounded-memory budget.
    """

    def __init__(self, *, n_rep: int, chunk_rows: int, seed: int = 0,
                 meta_levels: int = 3,
                 sub_params: Optional[HNSWParams] = None,
                 ov_cap: int = 0, slot_vecs: int = 64,
                 np_max: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 quant_group: int = 0):
        assert chunk_rows > 0, chunk_rows
        self.n_rep = n_rep
        self.quant_group = int(quant_group)
        self.chunk_rows = chunk_rows
        self.seed = seed
        self.meta_levels = meta_levels
        self.sub_params = sub_params
        self.ov_cap = ov_cap
        self.slot_vecs = slot_vecs
        self.np_max = np_max
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="repro_ingest_")
        os.makedirs(self.spill_dir, exist_ok=True)
        self.spill_path = os.path.join(self.spill_dir, "spill.f32")
        self._spill = open(self.spill_path, "wb")
        self.dim: Optional[int] = None
        self.rows = 0
        self.error_queue: List[FailedChunk] = []
        self.report = LoadReport(chunk_rows=chunk_rows,
                                 spill_path=self.spill_path)
        self._resident: dict = {}
        self._chunk_idx = 0

    # ------------------------------------------------- memory accounting

    def _hold(self, name: str, nbytes: int) -> None:
        self._resident[name] = int(nbytes)
        total = sum(self._resident.values())
        if total > self.report.peak_builder_bytes:
            self.report.peak_builder_bytes = total

    def _drop(self, name: str) -> None:
        self._resident.pop(name, None)

    # ------------------------------------------------------------ pass 1

    def _parse(self, chunk) -> np.ndarray:
        arr = np.asarray(chunk, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"chunk must be 2-D, got shape {arr.shape}")
        return arr

    def _validate(self, arr: np.ndarray) -> None:
        if self.dim is not None and arr.shape[1] != self.dim:
            raise ValueError(f"dim {arr.shape[1]} != {self.dim}")
        if not np.isfinite(arr).all():
            raise ValueError("non-finite values in chunk")

    def _accept(self, arr: np.ndarray) -> None:
        if self.dim is None:
            self.dim = int(arr.shape[1])
            self.report.dim = self.dim
            self.report.chunk_bytes = self.chunk_rows * self.dim * 4
        self._hold("chunk", arr.nbytes)
        self._spill.write(np.ascontiguousarray(arr).tobytes())
        self.rows += int(arr.shape[0])
        self._drop("chunk")

    def add_chunks(self, source: Iterable) -> "BulkLoader":
        """Pass 1: parse -> validate -> spill each chunk; failures go to
        the error queue instead of aborting."""
        for chunk in source:
            idx = self._chunk_idx
            self._chunk_idx += 1
            self.report.chunks_total += 1
            try:
                arr = self._parse(chunk)
                self._validate(arr)
            except (ValueError, TypeError) as e:
                self.error_queue.append(FailedChunk(idx, str(e), chunk))
                self.report.chunks_failed += 1
                self.report.failures.append((idx, str(e)))
                continue
            self._accept(arr)
            self.report.chunks_ok += 1
        return self

    def retry_failed(self, fix: Optional[Callable] = None) -> int:
        """Re-run parse/validate on the error queue (after an optional
        ``fix`` transform); returns how many chunks were recovered."""
        recovered = 0
        still: List[FailedChunk] = []
        for fc in self.error_queue:
            fc.retries += 1
            try:
                arr = self._parse(fix(fc.chunk) if fix else fc.chunk)
                self._validate(arr)
            except (ValueError, TypeError) as e:
                fc.reason = str(e)
                still.append(fc)
                continue
            self._accept(arr)
            recovered += 1
            self.report.chunks_ok += 1
            self.report.chunks_failed -= 1
            self.report.chunks_retried += 1
        self.error_queue = still
        return recovered

    # ------------------------------------------------------------ pass 2

    def data_view(self) -> np.ndarray:
        """Read-only disk-backed view of every accepted row (the
        engine's repack ``data_lookup`` reads through this, so holding
        it does not count against builder RAM)."""
        assert self.dim is not None, "no chunks accepted yet"
        self._spill.flush()
        return np.memmap(self.spill_path, np.float32, mode="r",
                         shape=(self.rows, self.dim))

    def _assign(self, reps: np.ndarray, data: np.ndarray) -> np.ndarray:
        """Exact nearest-rep assignment, streamed chunk-by-chunk.

        Per-row results are independent, so chunking reproduces the
        in-memory ``build_meta`` assignment bit-for-bit.
        """
        out = np.empty(self.rows, np.int32)
        for s in range(0, self.rows, self.chunk_rows):
            sl = data[s:s + self.chunk_rows]
            self._hold("assign_chunk",
                       sl.shape[0] * self.dim * 4
                       + sl.shape[0] * len(reps) * 4)
            _, nn = brute_force_knn(reps, np.asarray(sl), 1)
            out[s:s + self.chunk_rows] = nn[:, 0].astype(np.int32)
            self._drop("assign_chunk")
        return out

    def finalize(self, into_pool=None):
        """Pass 2: build meta + serialize the region from the spill.

        Returns ``(meta, store, report)``.  With ``into_pool`` set, each
        finished group is shipped immediately through the pool's
        ``refresh_blocks`` verb (the server-side region fills while the
        builder still holds only O(chunk)).
        """
        if self.error_queue:
            # two-stage contract: the caller decides — retry or accept
            # the loss; finalize proceeds over the accepted rows only
            pass
        assert self.rows > 0, "nothing to finalize"
        self._spill.flush()
        os.fsync(self._spill.fileno())
        data = self.data_view()
        self.report.rows = self.rows
        self.report.dataset_bytes = self.rows * self.dim * 4

        with TRACER.span("ingest.meta_stream", tier="ingest",
                         rows=int(self.rows)):
            rep_ids = ME.rep_sample_ids(self.rows, self.n_rep,
                                        seed=self.seed)
            reps = np.array(data[rep_ids], np.float32)
            self._hold("reps", reps.nbytes)
            assignments = self._assign(reps, data)
            meta = ME.build_meta_from_parts(reps, rep_ids, assignments,
                                            seed=self.seed,
                                            meta_levels=self.meta_levels)

        p = self.sub_params or HNSWParams(M=8, M0=16, ef_construction=80)
        spec, parts = LA.plan_spec(meta, self.dim, deg=p.M0,
                                   ov_cap=self.ov_cap,
                                   slot_vecs=self.slot_vecs,
                                   np_max=self.np_max)
        store = LA.empty_store(spec)
        group_blocks = spec.group_blocks
        for pid in range(meta.n_partitions):
            ids = LA.partition_member_ids(meta, parts, pid, spec.np_max)
            self._hold("stage", ids.size * self.dim * 4)
            LA.serialize_partition(store, pid, ids,
                                   np.asarray(data[ids], np.float32), 0, p)
            self._drop("stage")
            group_done = pid % 2 == 1 or pid == meta.n_partitions - 1
            if into_pool is not None and group_done:
                group = pid // 2
                into_pool.refresh_blocks(
                    np.arange(group * group_blocks,
                              (group + 1) * group_blocks))
                self.report.verbs_issued += 1
                self.report.groups_shipped += 1
        self._drop("reps")
        if self.quant_group:
            self._quantize_region(store)
        return meta, store, self.report

    def _quantize_region(self, store) -> None:
        """Second finalize sweep: build the int8 mirror chunk-by-chunk.

        The codec is per-row independent (``quant.codec``), so
        quantizing ``~chunk_rows`` worth of blocks at a time is
        bit-identical to ``layout.attach_quant_mirror``'s whole-buffer
        shot while the builder holds only O(chunk) working set (the
        mirror itself is region state, like the buffers it mirrors)."""
        import dataclasses as DC
        spec = store.spec
        if spec.dim % self.quant_group:
            raise ValueError(f"quant group {self.quant_group} must divide "
                             f"dim {spec.dim}")
        if spec.quant_group != self.quant_group:
            store.spec = spec = DC.replace(spec,
                                           quant_group=self.quant_group)
        store.qvec_buf = np.zeros((spec.n_blocks, spec.vblk), np.int8)
        store.qscale_buf = np.zeros((spec.n_blocks, spec.n_qgroups),
                                    np.float32)
        blk_chunk = max(1, self.chunk_rows // spec.slot_vecs)
        with TRACER.span("ingest.quant_stream", tier="ingest",
                         blocks=int(spec.n_blocks)):
            for s in range(0, spec.n_blocks, blk_chunk):
                ids = np.arange(s, min(s + blk_chunk, spec.n_blocks))
                # f32 source slice + codes + scales, live at once
                self._hold("quant_chunk",
                           len(ids) * (spec.vblk * 5 + spec.n_qgroups * 4))
                LA.refresh_quant_blocks(store, ids)
                self._drop("quant_chunk")

    def close(self) -> None:
        """Close the spill file handle (the memmap view stays valid)."""
        try:
            self._spill.close()
        except ValueError:
            pass

"""Host-side registered memory regions (the passive memory node).

A pool server does not implement read verbs — it *registers* its
serialized region as a set of :class:`HostMR` objects (numpy views over
the ``core/layout.Store`` buffers, one per rkey) and answers any
one-sided READ by delegating to the MR the request's rkey names:
decode the logical address batch, gather the bytes those addresses
resolve to, encode the response.  ``repro/net/server.HostRegion`` keeps
exactly one generic dispatch line per read opcode; all span/row gather
logic lives here.

MRs hold their *owner* (any object with a ``.store`` attribute), not a
buffer: an ATTACH that replaces the store, or an append that mutates it
in place, is visible to every registered MR immediately — the region is
the source of truth, registration is just a named window onto it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import layout as LA
from repro_torch.rdma import verbs as V


class HostMR:
    """One registered window onto the owner's region.

    Subclasses define ``rkey``/``name`` and implement :meth:`read` as
    ``(request_payload, flags) -> (response_payload, response_flags)``
    — the full one-sided READ service for that window.
    """

    rkey = 0
    name = ""

    def __init__(self, owner):
        self.owner = owner

    def _store(self):
        st = self.owner.store
        if st is None:
            raise RuntimeError("no region attached")
        return st

    def descriptor(self) -> V.MemoryRegion:
        """The ``(rkey, addr, len)`` registration this MR advertises."""
        spec = self._store().spec
        return V.region_mrs(spec, quant=True)[self.rkey]

    def read(self, payload: bytes, flags: int):
        """Serve one one-sided READ batch against this window."""
        raise NotImplementedError


class SpanMR(HostMR):
    """Span window: addr = partition id, one unit = one fetch span.

    Serves exact (graph + vec blocks) and quantized (int8 codes +
    codebooks, with full graph blocks or just the gid tails) span
    batches; the response payload is exactly the modeled span bytes.
    """

    rkey = V.RKEY_SPANS
    name = "spans"

    def _span_blocks(self, buf, pids):
        store = self._store()
        ids = np.stack([store.span_block_ids(int(p)) for p in pids]) \
            if len(pids) else np.zeros((0, store.spec.fetch_blocks),
                                       np.int64)
        return buf[ids.reshape(-1)].reshape(
            len(pids), store.spec.fetch_blocks, buf.shape[1])

    def _gid_tails(self, pids) -> np.ndarray:
        # slice the two gid runs of each span straight out of the region
        # (blocks are contiguous rows, so a run is contiguous in the
        # flat view) — no need to materialize the full graph span the
        # tails format exists to keep off the wire
        from repro_torch.net import wire as W
        store = self._store()
        spec = store.spec
        gflat = store.graph_buf.reshape(-1)           # view, no copy
        tails = np.empty((len(pids), spec.np_max + spec.ov_cap), np.int32)
        for i, p in enumerate(pids):
            row = store.meta_table[int(p)]
            base = int(row[LA.MT_BLK_START]) * spec.gblk
            d, o = W.gid_tail_offsets(spec, int(row[LA.MT_SIDE]))
            tails[i, :spec.np_max] = gflat[base + d:base + d + spec.np_max]
            tails[i, spec.np_max:] = gflat[base + o:base + o + spec.ov_cap]
        return tails

    def read(self, payload: bytes, flags: int):
        """One doorbell batch of span READs -> the span bytes."""
        from repro_torch.net import wire as W
        store = self._store()
        spec = store.spec
        pids = W.dec_pids(payload)
        quant = bool(flags & W.FLAG_QUANT)
        graph = bool(flags & W.FLAG_GRAPH)
        if not quant:
            g = self._span_blocks(store.graph_buf, pids)
            v = self._span_blocks(store.vec_buf, pids)
            return W.enc_spans_resp(spec, quant=False, g=g, v=v), 0
        if store.qvec_buf is None:
            raise RuntimeError("quant span read without an attached mirror")
        qv = self._span_blocks(store.qvec_buf, pids)
        qs = self._span_blocks(store.qscale_buf, pids)
        if graph:
            g = self._span_blocks(store.graph_buf, pids)
            return (W.enc_spans_resp(spec, quant=True, graph=True, qv=qv,
                                     qs=qs, g=g), flags)
        return (W.enc_spans_resp(spec, quant=True, graph=False, qv=qv,
                                 qs=qs, tails=self._gid_tails(pids)), flags)


class RowMR(HostMR):
    """f32 row window: addr = region row address, one unit = one row."""

    rkey = V.RKEY_ROWS
    name = "rows"

    def read(self, payload: bytes, flags: int):
        """Row-granular READ -> ``n_rows * row_bytes()`` f32."""
        from repro_torch.net import wire as W
        store = self._store()
        rows = W.dec_rows(payload)
        safe = np.maximum(rows, 0)
        vrows = store.vec_buf.reshape(-1, store.spec.dim)[safe]
        return W.enc_rows_resp(vrows), 0


class QuantRowMR(HostMR):
    """int8-mirror row window: codes + group scales per row address."""

    rkey = V.RKEY_QROWS
    name = "quant_rows"

    def read(self, payload: bytes, flags: int):
        """Quant-mirror row READ -> codes + codebook scales."""
        from repro_torch.net import wire as W
        store = self._store()
        if store.qvec_buf is None:
            raise RuntimeError("quant row read without an attached mirror")
        spec = store.spec
        rows = W.dec_rows(payload)
        safe = np.maximum(rows, 0)
        codes = store.qvec_buf.reshape(-1, spec.dim)[safe]
        scales = store.qscale_buf.reshape(
            -1, spec.dim // spec.quant_group)[safe]
        return W.enc_quant_rows_resp(codes, scales), 0


def host_mrs(owner) -> dict:
    """Register every readable window of ``owner``'s region.

    ``owner`` is any object with a ``.store`` attribute (a ``HostRegion``
    or a bare namespace); returns ``{rkey: HostMR}``.  Registration is
    done once — MRs dereference the owner's store per read, so region
    replacement (ATTACH) and in-place mutation both stay visible.
    """
    return {mr.rkey: mr for mr in (SpanMR(owner), RowMR(owner),
                                   QuantRowMR(owner))}

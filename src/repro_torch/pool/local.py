"""In-process memory pool: the serialized region as device tensors.

Port of ``repro/pool/local.py`` for this slice: full staging, span reads
through the doorbell gather (``kernels/gather_blocks``' ``gather_spans``,
one launch per span read for all its buffers, when ``use_gather_kernel``
is set; an ``index_select`` per buffer otherwise), row reads, and
the quantized mirror for the int8 flat route.  Charges follow the shared
``MemoryPool`` rule, so ledgers equal the reference's.

Not in this slice (they raise ``NotImplementedError``): the write verbs
and re-staging (``append``, ``repack``, ``adopt``, ``refresh_blocks``;
ROADMAP "Modules to port" item 5) and the 1/N compacted staging of
sharded children (``restrict_staging``, same item).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.core import device_store as DS
from repro_torch.core import layout as LA
from repro_torch.core.cost_model import NetLedger
from repro_torch.core.layout import Store
from repro_torch.core.scheduler import doorbell_chunks
from repro_torch.pool.protocol import (MemoryPool, _fresh_totals,
                                       span_wire_bytes)

_LATER = "ported with insert and mutation (ROADMAP 'Modules to port' item 5)"


class LocalPool(MemoryPool):
    """In-process transport: verbs are device gathers on the staged
    region; charges follow the shared ``MemoryPool`` rule."""

    kind = "local"

    def __init__(self, store: Store, *, device, use_gather_kernel: bool = False):
        self.store = store
        self.device = torch.device(device)
        self.use_gather_kernel = use_gather_kernel
        self.verbs: Counter = Counter()
        self.totals = _fresh_totals()
        self._stage_all()

    # ------------------------------------------------------------ staging

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _stage_all(self) -> None:
        """Register the region: host buffers -> device tensors."""
        st, spec = self.store, self.store.spec
        self._g_dev = self._to_dev(st.graph_buf)
        self._v_dev = self._to_dev(st.vec_buf)
        self._mt_dev = self._to_dev(st.meta_table)
        self._mt_dirty = False
        if st.qvec_buf is not None:
            self._stage_quant()
        else:
            self._qv_dev = self._qs_dev = None
        self.staging = {"compacted": False,
                        "blocks_total": int(spec.n_blocks),
                        "blocks_staged": int(spec.n_blocks),
                        "restaged_blocks": 0,
                        "device_bytes": 0}
        self._count_device_bytes()

    def _count_device_bytes(self) -> None:
        ts = [self._g_dev, self._v_dev, self._mt_dev]
        if self._qv_dev is not None:
            ts += [self._qv_dev, self._qs_dev]
        self.staging["device_bytes"] = int(
            sum(t.numel() * t.element_size() for t in ts))

    def attach_quant(self, group: int) -> None:
        """See ``MemoryPool.attach_quant``."""
        LA.attach_quant_mirror(self.store, group)
        self._stage_quant()
        self._count_device_bytes()

    def _stage_quant(self) -> None:
        """(Re-)stage the quantized mirror already attached to the host
        store."""
        self._qv_dev = self._to_dev(self.store.qvec_buf)
        self._qs_dev = self._to_dev(self.store.qscale_buf)
        if hasattr(self, "staging"):
            self._count_device_bytes()

    def restrict_staging(self, groups) -> None:
        """1/N compacted staging for sharded children — not in this slice."""
        raise NotImplementedError("restrict_staging: " + _LATER)

    def refresh_blocks(self, block_ids) -> None:
        """Re-stage blocks after a group migration — not in this slice."""
        raise NotImplementedError("refresh_blocks: " + _LATER)

    def adopt(self, store: Store) -> None:
        """Re-register a rebuilt region — not in this slice."""
        raise NotImplementedError("adopt: " + _LATER)

    # ------------------------------------------------------------ reads

    def _gather_spans(self, bufs, ids) -> list:
        """One span read from every buffer of ``bufs``: one launch of the
        CUDA gather when ``use_gather_kernel`` is set, else an
        ``index_select`` per buffer."""
        if self.use_gather_kernel:
            from repro_torch.kernels.gather_blocks import ops as GO
            return GO.gather_spans(bufs, ids)
        return [buf.index_select(0, ids.long()) for buf in bufs]

    def read_spans(self, pids, *, ledger: Optional[NetLedger],
                   doorbell: int = 1, quant: bool = False,
                   quant_graph: bool = True):
        """See ``MemoryPool.read_spans``; charges
        ``span_wire_bytes(spec, quant=...)`` per span, ``doorbell``
        descriptors per round trip."""
        spec = self.spec
        pids = np.asarray(pids).reshape(-1)
        self.verbs["read_spans_quant" if quant else "read_spans"] += len(pids)
        per_bytes, per_desc = span_wire_bytes(spec, quant=quant,
                                              quant_graph=quant_graph)
        if ledger is not None:
            for db in doorbell_chunks(pids, doorbell):
                self._charge("read_spans_quant" if quant else "read_spans",
                             ledger, len(db) * per_bytes,
                             per_desc * len(db))
        block_ids = np.stack([self.store.span_block_ids(int(p))
                              for p in pids])
        ids = torch.as_tensor(block_ids.reshape(-1), dtype=torch.int32,
                              device=self.device)
        m = block_ids.shape[0]
        if not quant:
            g, v = self._gather_spans((self._g_dev, self._v_dev), ids)
            return (g.reshape(m, -1, spec.gblk),
                    v.reshape(m, -1, spec.vblk))
        g, qv, qs = self._gather_spans(
            (self._g_dev, self._qv_dev, self._qs_dev), ids)
        return (g.reshape(m, -1, spec.gblk), qv.reshape(m, -1, spec.vblk),
                qs.reshape(m, -1, spec.n_qgroups))

    def read_rows(self, rows):
        """See ``MemoryPool.read_rows``; charged via ``post_row_reads``."""
        self.verbs["read_rows"] += 1
        return DS.gather_rows(self._v_dev, rows, dim=self.spec.dim)

    def read_quant_rows(self, rows):
        """See ``MemoryPool.read_quant_rows``; charged via
        ``post_row_reads`` (quant rows are priced by the caller)."""
        self.verbs["read_quant_rows"] += 1
        return DS.gather_quant_rows(self._qv_dev, self._qs_dev, rows,
                                    dim=self.spec.dim,
                                    group=self.spec.quant_group)

    # ------------------------------------------------------------ writes

    def append(self, vec, gid: int, pid: int, *,
               ledger: Optional[NetLedger]) -> int:
        """One-sided overflow WRITE — not in this slice."""
        raise NotImplementedError("append: " + _LATER)

    def repack(self, group: int, data_lookup) -> bool:
        """Offline re-pack of one group — not in this slice."""
        raise NotImplementedError("repack: " + _LATER)

    # ------------------------------------------------------------ stats

    def snapshot(self) -> dict:
        """See ``MemoryPool.snapshot``; adds the device-staging tallies."""
        out = super().snapshot()
        out["staging"] = dict(self.staging)
        return out

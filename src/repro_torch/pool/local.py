"""In-process memory pool: the serialized region as device tensors.

Port of ``repro/pool/local.py``: span reads are device gathers from the
staged region (``kernels/gather_blocks``' ``gather_spans``, one launch
per span read for all its buffers, when ``use_gather_kernel`` is set; an
``index_select`` per buffer otherwise), row reads are device gathers, and
writes are host staging plus an in-place device scatter twin (and the
quantized mirror's twin when it is attached).  Charges follow the shared
``MemoryPool`` rule, so ledgers equal the reference's.

1/N staging: a sharded child that serves only some partition groups can
``restrict_staging(groups)`` to a block-compacted device region holding
just the owned groups' blocks.  Reads translate region block/row
addresses through a block->staged-slot indirection
(``layout.block_slot_map``) — on the host for span block ids, on the
device for row gathers (dead ``-1`` lanes stay dead) — so verb results
equal the fully staged pool's while device bytes drop to ~1/N.
``refresh_blocks`` adopts an arriving group at group granularity (staged
once from the host onto the compacted tail) and scatters only the blocks
that moved; ``snapshot()["staging"]`` reports the compaction and
re-stage tallies.

On the CPU ``torch.as_tensor`` aliases the host buffers, so there the
device twin's writes land on bytes the host write already changed; on
the card they are the only writes to the device copy.
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
from repro_torch.obs.trace import TRACER
from repro_torch.pool.protocol import (MemoryPool, _fresh_totals,
                                       span_wire_bytes)


class LocalPool(MemoryPool):
    """In-process transport: verbs are device gathers/scatters on the
    staged region; charges follow the shared ``MemoryPool`` rule."""

    kind = "local"

    def __init__(self, store: Store, *, device,
                 use_gather_kernel: bool = False, owned_groups=None):
        self.store = store
        self.device = torch.device(device)
        self.use_gather_kernel = use_gather_kernel
        self.verbs: Counter = Counter()
        self.totals = _fresh_totals()
        self._owned: Optional[set] = (None if owned_groups is None
                                      else {int(g) for g in owned_groups})
        self._stage_all()

    # ------------------------------------------------------------ staging

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def restrict_staging(self, groups) -> None:
        """Compact the device region to only ``groups``' blocks (the 1/N
        staging a sharded child uses once placement is known).  Pass
        ``None`` to return to full staging."""
        self._owned = None if groups is None else {int(g) for g in groups}
        self._stage_all()

    def _stage_all(self) -> None:
        """(Re-)register the region: host buffers -> device tensors.

        Full staging when no owned set is declared; otherwise only the
        owned groups' blocks go to the device, block-compacted, with the
        region->staged indirection rebuilt alongside."""
        st, spec = self.store, self.store.spec
        if self._owned is None:
            self._staged_ids = None
            self._block_slot = None
            self._bs_dev = None
            self._g_dev = self._to_dev(st.graph_buf)
            self._v_dev = self._to_dev(st.vec_buf)
            n_staged = spec.n_blocks
        else:
            self._staged_ids = LA.owned_block_ids(spec, self._owned)
            self._block_slot = LA.block_slot_map(spec, self._staged_ids)
            self._bs_dev = self._to_dev(self._block_slot)
            self._g_dev = self._to_dev(st.graph_buf[self._staged_ids])
            self._v_dev = self._to_dev(st.vec_buf[self._staged_ids])
            n_staged = len(self._staged_ids)
        self._mt_dev = self._to_dev(st.meta_table)
        self._mt_dirty = False
        if st.qvec_buf is not None:
            self._stage_quant()
        else:
            self._qv_dev = self._qs_dev = None
        self.staging = {"compacted": self._owned is not None,
                        "blocks_total": int(spec.n_blocks),
                        "blocks_staged": int(n_staged),
                        "restaged_blocks": 0,
                        "device_bytes": 0}
        self._count_device_bytes()

    def _count_device_bytes(self) -> None:
        ts = [self._g_dev, self._v_dev, self._mt_dev]
        if self._qv_dev is not None:
            ts += [self._qv_dev, self._qs_dev]
        self.staging["device_bytes"] = int(
            sum(t.numel() * t.element_size() for t in ts))

    def adopt(self, store: Store) -> None:
        """See ``MemoryPool.adopt``."""
        self.store = store
        self._stage_all()

    def attach_quant(self, group: int) -> None:
        """See ``MemoryPool.attach_quant``."""
        LA.attach_quant_mirror(self.store, group)
        self._stage_quant()
        self._count_device_bytes()

    def _stage_quant(self) -> None:
        """(Re-)stage the quantized mirror already attached to the host
        store.  Compacted staging stages only the owned blocks' codes and
        scales, through the same indirection."""
        ids = self._staged_ids
        if ids is None:
            self._qv_dev = self._to_dev(self.store.qvec_buf)
            self._qs_dev = self._to_dev(self.store.qscale_buf)
        else:
            self._qv_dev = self._to_dev(self.store.qvec_buf[ids])
            self._qs_dev = self._to_dev(self.store.qscale_buf[ids])
        if hasattr(self, "staging"):
            self._count_device_bytes()

    def refresh_blocks(self, block_ids) -> None:
        """Re-stage specific blocks from the host region (a group
        migration landing on this pool: the host bytes are the source of
        truth; this node's device copy of the arriving group is stale).

        Under compacted staging an arriving group not yet owned is
        adopted at group granularity — its full block range is staged
        once from the host onto the compacted tail — and only the blocks
        that were already resident are scattered; either way just the
        moved group's blocks travel, never a full re-stage."""
        ids = np.asarray(block_ids, np.int64)
        if len(ids) == 0:
            return
        if self._owned is None:
            self._scatter_blocks(ids, ids)
            self.staging["restaged_blocks"] += int(len(ids))
            return
        spec = self.spec
        new_groups = sorted({int(g) for g in ids // spec.group_blocks}
                            - self._owned)
        for g in new_groups:
            self._adopt_group(g)
        pre = (ids[~np.isin(ids // spec.group_blocks, new_groups)]
               if new_groups else ids)
        if len(pre):
            slots = self._block_slot[pre]
            assert (slots >= 0).all(), "refresh of unstaged block"
            self._scatter_blocks(pre, slots)
        self.staging["restaged_blocks"] += (
            int(len(pre)) + len(new_groups) * spec.group_blocks)
        self.staging["blocks_staged"] = int(len(self._staged_ids))
        self._count_device_bytes()

    def _scatter_blocks(self, host_ids: np.ndarray, dev_ids) -> None:
        """Copy the host region's blocks ``host_ids`` onto the device rows
        ``dev_ids``, in place."""
        st = self.store
        rows = torch.as_tensor(np.asarray(dev_ids, np.int64),
                               device=self.device)
        self._g_dev[rows] = self._to_dev(st.graph_buf[host_ids])
        self._v_dev[rows] = self._to_dev(st.vec_buf[host_ids])
        if self._qv_dev is not None:
            self._qv_dev[rows] = self._to_dev(st.qvec_buf[host_ids])
            self._qs_dev[rows] = self._to_dev(st.qscale_buf[host_ids])

    def _adopt_group(self, group: int) -> None:
        """Stage one newly owned group onto the compacted device tail."""
        st, spec = self.store, self.spec
        gids = np.arange(group * spec.group_blocks,
                         (group + 1) * spec.group_blocks, dtype=np.int64)
        base = len(self._staged_ids)
        self._staged_ids = np.concatenate([self._staged_ids, gids])
        self._block_slot[gids] = base + np.arange(spec.group_blocks,
                                                  dtype=np.int32)
        self._bs_dev = self._to_dev(self._block_slot)
        self._g_dev = torch.cat(
            [self._g_dev, self._to_dev(st.graph_buf[gids])])
        self._v_dev = torch.cat(
            [self._v_dev, self._to_dev(st.vec_buf[gids])])
        if self._qv_dev is not None:
            self._qv_dev = torch.cat(
                [self._qv_dev, self._to_dev(st.qvec_buf[gids])])
            self._qs_dev = torch.cat(
                [self._qs_dev, self._to_dev(st.qscale_buf[gids])])
        self._owned.add(int(group))

    # ------------------------------------------------------------ reads

    def _gather_spans(self, bufs, ids) -> list:
        """One span read from every buffer of ``bufs``: one launch of the
        CUDA gather when ``use_gather_kernel`` is set, else an
        ``index_select`` per buffer."""
        if self.use_gather_kernel:
            from repro_torch.kernels.gather_blocks import ops as GO
            return GO.gather_spans(bufs, ids)
        return [buf.index_select(0, ids.long()) for buf in bufs]

    def _staged_block_ids(self, block_ids: np.ndarray) -> np.ndarray:
        """Region block ids -> device rows (identity when fully staged)."""
        if self._owned is None:
            return block_ids
        slots = self._block_slot[block_ids]
        assert (slots >= 0).all(), "span read outside the staged groups"
        return slots

    def _staged_rows(self, rows):
        """Region row addresses -> compacted device rows, ON THE DEVICE.

        Rows address ``vec_buf.reshape(-1, dim)``; under compaction the
        owning block is remapped through the staged-slot table and the
        in-block offset is kept.  Dead ``-1`` lanes and rows of unstaged
        blocks stay ``-1`` (callers mask them)."""
        if self._owned is None:
            return rows
        sv = self.spec.slot_vecs
        r = torch.as_tensor(rows, device=self.device)
        safe = r.clamp(min=0)
        slot = self._bs_dev[(safe // sv).long()]
        tr = slot * sv + safe % sv
        return torch.where((r < 0) | (slot < 0), -1, tr).to(r.dtype)

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
        block_ids = self._staged_block_ids(block_ids)
        with TRACER.wait("upload"):
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
        return DS.gather_rows(self._v_dev, self._staged_rows(rows),
                              dim=self.spec.dim)

    def read_quant_rows(self, rows):
        """See ``MemoryPool.read_quant_rows``; charged via
        ``post_row_reads`` (quant rows are priced by the caller)."""
        self.verbs["read_quant_rows"] += 1
        return DS.gather_quant_rows(self._qv_dev, self._qs_dev,
                                    self._staged_rows(rows),
                                    dim=self.spec.dim,
                                    group=self.spec.quant_group)

    # ------------------------------------------------------------ writes

    def append(self, vec, gid: int, pid: int, *,
               ledger: Optional[NetLedger]) -> int:
        """See ``MemoryPool.append``; charges vector + 8 B id, plus
        codes + codebook scales when the quantized mirror is attached."""
        spec = self.spec
        vec = np.asarray(vec, np.float32)
        slot = LA.insert_vector(self.store, vec, int(gid), int(pid))
        if slot < 0:
            return slot
        group = int(self.store.meta_table[pid, LA.MT_GROUP])
        co = LA.overflow_write_coords(spec, group, slot)
        vb, gb = co["vec_block"], co["gid_block"]
        if self._owned is not None:
            vb, gb = int(self._block_slot[vb]), int(self._block_slot[gb])
            assert vb >= 0 and gb >= 0, "append to an unstaged group"
        vec_dev = self._to_dev(vec)
        DS.overflow_append(spec, self._g_dev, self._v_dev, vec_dev,
                           int(gid), vb, co["vec_off"], gb, co["gid_off"])
        wire = spec.dim * 4 + 8
        if self.store.qvec_buf is not None:
            # quantized-mirror twin: re-quantize the touched block on the
            # host, scatter codes + codebook scales on the device, and pay
            # the extra one-sided WRITE on the wire
            LA.refresh_quant_blocks(self.store, [co["vec_block"]])
            DS.overflow_append_quant(spec, self._qv_dev, self._qs_dev,
                                     vec_dev, vb, co["vec_off"])
            wire += spec.dim + (spec.dim // spec.quant_group) * 4
        self.verbs["append"] += 1
        self._charge_write("append", ledger, wire)
        self._mt_dirty = True      # overflow counters moved
        self._notify_mutation("append", group=group, pid=int(pid),
                              slot=int(slot))
        return slot

    def repack(self, group: int, data_lookup) -> bool:
        """See ``MemoryPool.repack``; in-process, so nothing is charged
        (the offline repack is not on the query wire)."""
        self.verbs["repack"] += 1
        ok = LA.repack_group(self.store, group, data_lookup)
        if ok:
            LA.refresh_quant_group(self.store, group)
            self._stage_all()      # re-register the rewritten region
            self._notify_mutation("repack", group=int(group))
        return ok

    # ------------------------------------------------------------ stats

    def snapshot(self) -> dict:
        """See ``MemoryPool.snapshot``; adds the device-staging tallies
        (compaction, staged block count, device bytes, re-stages)."""
        out = super().snapshot()
        out["staging"] = dict(self.staging)
        return out

"""RDMA-friendly graph-index storage layout — paper §3.2, TPU-adapted.

One registered memory region per buffer, divided into fixed-size blocks
(the doorbell/DMA granularity).  Groups of two sub-HNSW clusters share a
single overflow region in the middle:

    group g:  [ sub-HNSW A | shared overflow | sub-HNSW B ]
              `-- fetch A --------------'
                          `-------------- fetch B --'

so one contiguous read returns a cluster *and* every vector ever inserted
into it — the paper's core layout invariant.  A global metadata table
(per-partition offsets/counters) sits logically at the start of the
region; compute instances cache it (here: small replicated array + host
mirror).

TPU adaptation (recorded in DESIGN.md): JAX arrays are typed, so the
byte region becomes two lockstep block buffers — ``graph_buf`` (int32:
adjacency + global ids) and ``vec_buf`` (float32: vectors) — with
identical block indexing; and partitions are padded to the build-max
partition size ``np_max`` so every fetch span is the same number of
blocks (static shapes).  Uniform sampling makes partitions multinomial-
balanced (sigma/mean = 1/sqrt(mean)), so measured padding waste is ~7-15%
and is reported by ``Store.padding_waste()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.hnsw import HNSW, HNSWParams, bulk_l0_graph
from repro_torch.core.meta import MetaIndex

# meta_table columns (int32)
MT_BLK_START = 0   # first block of this partition's fetch span
MT_SIDE = 1        # 0 = A (data first), 1 = B (overflow first)
MT_N_BASE = 2      # base vectors in the sub-HNSW
MT_ENTRY = 3       # entry node (local id) = the representative
MT_OV_A = 4        # overflow slots used from the front (partner A)
MT_OV_B = 5        # overflow slots used from the back (partner B)
MT_GROUP = 6
META_COLS = 8      # padded for alignment / future fields


@dataclass(frozen=True)
class LayoutSpec:
    """All build-time constants the device decode path needs (static)."""

    dim: int
    deg: int               # sub-HNSW L0 degree (M0)
    np_max: int            # max base vectors per partition (pad target)
    ov_cap: int            # overflow vector slots per group (shared)
    slot_vecs: int         # vectors per block (VBLK = slot_vecs * dim)
    n_partitions: int
    quant_group: int = 0   # int8 codec group size (0 = no quantized mirror)

    @property
    def vblk(self) -> int:           # floats per vec block
        return self.slot_vecs * self.dim

    @property
    def gblk(self) -> int:           # ints per graph block
        return self.slot_vecs * (self.deg + 1)

    @property
    def data_blocks(self) -> int:    # blocks for one padded sub-HNSW
        g = math.ceil(self.np_max * (self.deg + 1) / self.gblk)
        v = math.ceil(self.np_max * self.dim / self.vblk)
        return max(g, v)

    @property
    def ov_blocks(self) -> int:      # blocks for one shared overflow region
        g = math.ceil(self.ov_cap / self.gblk)
        v = math.ceil(self.ov_cap * self.dim / self.vblk)
        return max(g, v)

    @property
    def fetch_blocks(self) -> int:   # every fetch span: data + overflow
        return self.data_blocks + self.ov_blocks

    @property
    def group_blocks(self) -> int:
        return 2 * self.data_blocks + self.ov_blocks

    @property
    def n_groups(self) -> int:
        return (self.n_partitions + 1) // 2

    @property
    def n_blocks(self) -> int:
        return self.n_groups * self.group_blocks

    def block_bytes(self) -> int:
        """Wire bytes of one block fetch (both lockstep buffers)."""
        return self.vblk * 4 + self.gblk * 4

    def partition_bytes(self) -> int:
        return self.fetch_blocks * self.block_bytes()

    # ------------------------------------------------- quantized mirror

    @property
    def n_qgroups(self) -> int:      # codec groups per vec block
        assert self.quant_group > 0
        return self.vblk // self.quant_group

    def quant_block_bytes(self, *, include_graph: bool = True) -> int:
        """Wire bytes of one quantized block fetch: int8 codes + f32
        codebook scales (+ the int32 graph block when the search mode
        walks the sub-HNSW).  In scan mode only the global-id tail of the
        graph span is needed, priced separately per span below."""
        b = self.vblk * 1 + self.n_qgroups * 4
        return b + (self.gblk * 4 if include_graph else 0)

    def quant_partition_bytes(self, *, include_graph: bool = True) -> int:
        """One quantized span fetch.  Without the graph, the span still
        carries the global-id tails (np_max + ov_cap int32) so the
        candidate pool can name real ids."""
        b = self.fetch_blocks * self.quant_block_bytes(
            include_graph=include_graph)
        if not include_graph:
            b += (self.np_max + self.ov_cap) * 4
        return b

    def row_bytes(self) -> int:      # one exact vector row (re-rank fetch)
        return self.dim * 4

    def data_blk_off(self, side: int) -> int:
        return side * self.ov_blocks        # B's data sits after the overflow

    def ov_blk_off(self, side: int) -> int:
        return (1 - side) * self.data_blocks  # A's overflow sits after its data


@dataclass
class Store:
    """The serialized memory-pool region (host copy; device_put to serve)."""

    spec: LayoutSpec
    graph_buf: np.ndarray   # (n_blocks, gblk) i32
    vec_buf: np.ndarray     # (n_blocks, vblk) f32
    meta_table: np.ndarray  # (P, META_COLS) i32  ("global metadata block")
    n_base: np.ndarray      # (P,) convenience copy of MT_N_BASE
    # quantized mirror (attach_quant_mirror): codebook blocks appended to
    # the region with IDENTICAL block indexing, so every span helper above
    # addresses both precisions
    qvec_buf: Optional[np.ndarray] = None    # (n_blocks, vblk) int8
    qscale_buf: Optional[np.ndarray] = None  # (n_blocks, n_qgroups) f32

    def total_bytes(self) -> int:
        return self.graph_buf.nbytes + self.vec_buf.nbytes

    def padding_waste(self) -> float:
        used = int(self.n_base.sum()) * (self.spec.dim * 4 + (self.spec.deg + 1) * 4)
        return 1.0 - used / max(self.total_bytes(), 1)

    def fetch_span(self, pid: int) -> tuple[int, int]:
        """(first_block, n_blocks) of partition ``pid`` — what one
        contiguous RDMA_READ (or one doorbell descriptor) covers."""
        row = self.meta_table[pid]
        return int(row[MT_BLK_START]), self.spec.fetch_blocks

    def span_block_ids(self, pid: int) -> np.ndarray:
        s, n = self.fetch_span(pid)
        return np.arange(s, s + n, dtype=np.int32)


def serialize_partition(store: Store, pid: int, local_gids: np.ndarray,
                        vectors: np.ndarray, entry_local: int = 0,
                        sub_params: Optional[HNSWParams] = None) -> None:
    """(Re)build partition ``pid``'s sub-HNSW and serialize it in place.

    ``local_gids``: global ids of the member vectors; ``vectors``: their
    rows, same order.  Requires ``len(local_gids) <= spec.np_max``.
    """
    spec = store.spec
    p = sub_params or HNSWParams(M=max(spec.deg // 2, 2), M0=spec.deg,
                                 ef_construction=80)
    n = len(local_gids)
    assert n <= spec.np_max, (n, spec.np_max)
    side = pid % 2
    group = pid // 2
    gstart = group * spec.group_blocks
    data_blk = gstart + (0 if side == 0 else spec.data_blocks + spec.ov_blocks)

    adj = np.full((spec.np_max, spec.deg), -1, np.int32)
    if n:
        # bulk offline L0 build (exact kNN + HNSW heuristic prune) — the
        # paper also builds sub-HNSWs offline; see hnsw.bulk_l0_graph
        adj[:n] = bulk_l0_graph(np.asarray(vectors, np.float32), spec.deg)

    gflat = store.graph_buf[data_blk:data_blk + spec.data_blocks].reshape(-1)
    gids = np.full((spec.np_max,), -1, np.int32)
    gids[:n] = local_gids
    gflat[: spec.np_max * spec.deg] = adj.reshape(-1)
    gflat[spec.np_max * spec.deg: spec.np_max * (spec.deg + 1)] = gids

    vflat = store.vec_buf[data_blk:data_blk + spec.data_blocks].reshape(-1)
    vecs = np.zeros((spec.np_max, spec.dim), np.float32)
    vecs[:n] = vectors
    vflat[: spec.np_max * spec.dim] = vecs.reshape(-1)

    row = store.meta_table[pid]
    # A's span: [data | ov] from the group start; B's: [ov | data] — the
    # shared overflow is covered by BOTH sides' single contiguous read
    row[MT_BLK_START] = gstart + side * spec.data_blocks
    row[MT_SIDE] = side
    row[MT_N_BASE] = n
    row[MT_ENTRY] = entry_local
    row[MT_GROUP] = group
    store.n_base[pid] = n


def plan_spec(meta: MetaIndex, dim: int, *, deg: int = 16,
              ov_cap: int = 0, slot_vecs: int = 64,
              np_max: Optional[int] = None):
    """Plan the region geometry for a partitioned dataset.

    Returns ``(spec, parts)`` where ``parts`` is
    ``meta.partition_lists()``.  Split out of :func:`build_store` so the
    out-of-core loader plans the *identical* layout from the same meta.
    """
    parts = meta.partition_lists()
    sizes = np.array([len(x) + 1 for x in parts])  # +1: rep always present
    npm = int(np_max or max(int(sizes.max()), 1))
    if ov_cap <= 0:
        # paper sizes the shared region as a small fraction of a group
        ov_cap = max(16, int(0.1 * 2 * npm))
    spec = LayoutSpec(dim=dim, deg=deg, np_max=npm, ov_cap=ov_cap,
                      slot_vecs=slot_vecs, n_partitions=meta.n_partitions)
    return spec, parts


def empty_store(spec: LayoutSpec) -> Store:
    """Allocate a zeroed region for ``spec`` (graph ids initialized -1)."""
    return Store(spec=spec,
                 graph_buf=np.full((spec.n_blocks, spec.gblk), -1, np.int32),
                 vec_buf=np.zeros((spec.n_blocks, spec.vblk), np.float32),
                 meta_table=np.zeros((spec.n_partitions, META_COLS),
                                     np.int32),
                 n_base=np.zeros((spec.n_partitions,), np.int32))


def partition_member_ids(meta: MetaIndex, parts, pid: int,
                         np_max: int) -> np.ndarray:
    """Member global ids of partition ``pid``, representative first,
    truncated to ``np_max`` — THE ordering rule every build path shares
    (entry_local = 0 relies on the rep being row 0)."""
    rep_gid = int(meta.rep_ids[pid])
    ids = [rep_gid] + [int(x) for x in parts[pid] if int(x) != rep_gid]
    return np.asarray(ids[:np_max], np.int64)


def build_store(data: np.ndarray, meta: MetaIndex, *,
                sub_params: Optional[HNSWParams] = None,
                ov_cap: int = 0, slot_vecs: int = 64,
                np_max: Optional[int] = None) -> Store:
    """Build every sub-HNSW and serialize the full memory-pool region."""
    data = np.asarray(data, np.float32)
    p = sub_params or HNSWParams(M=8, M0=16, ef_construction=80)
    spec, parts = plan_spec(meta, data.shape[1], deg=p.M0, ov_cap=ov_cap,
                            slot_vecs=slot_vecs, np_max=np_max)
    store = empty_store(spec)
    for pid in range(meta.n_partitions):
        ids = partition_member_ids(meta, parts, pid, spec.np_max)
        # entry_local = 0: the representative is inserted first
        serialize_partition(store, pid, ids, data[ids], 0, p)
    return store


# --------------------------------------------------- 1/N device staging

def owned_block_ids(spec: LayoutSpec, groups) -> np.ndarray:
    """Region block ids covered by the given partition groups, ascending.

    This is the staging set of a shard that serves only ``groups``: the
    concatenation of each owned group's contiguous block range.  Out-of-
    range group ids are dropped (a placement can mention groups a smaller
    re-adopted region no longer has)."""
    gs = sorted({int(g) for g in groups if 0 <= int(g) < spec.n_groups})
    if not gs:
        return np.zeros((0,), np.int64)
    return np.concatenate([np.arange(g * spec.group_blocks,
                                     (g + 1) * spec.group_blocks,
                                     dtype=np.int64) for g in gs])


def block_slot_map(spec: LayoutSpec, staged_ids) -> np.ndarray:
    """Region-block -> staged-slot indirection for a compacted staging.

    Returns an ``(n_blocks,)`` int32 map where staged blocks name their
    row in the compacted device region and every other block is ``-1``
    (a read hitting one is a placement bug — the pool asserts)."""
    ids = np.asarray(staged_ids, np.int64)
    m = np.full((spec.n_blocks,), -1, np.int32)
    m[ids] = np.arange(len(ids), dtype=np.int32)
    return m


# ----------------------------------------------------------------- insert

def insert_vector(store: Store, vec: np.ndarray, gid: int, pid: int):
    """Append one vector into partition ``pid``'s shared overflow region
    (host mirror).  Returns the slot index, or -1 when the group's shared
    region is full -> caller must repack the group (paper: offline
    re-pack), see ``repack_group``."""
    spec = store.spec
    row = store.meta_table[pid]
    side, group = int(row[MT_SIDE]), int(row[MT_GROUP])
    partner = group * 2 + (1 - side)
    cnt_a, cnt_b = int(row[MT_OV_A]), int(row[MT_OV_B])
    if cnt_a + cnt_b >= spec.ov_cap:
        return -1
    slot = cnt_a if side == 0 else spec.ov_cap - 1 - cnt_b

    co = overflow_write_coords(spec, group, slot)
    store.vec_buf[co["vec_block"],
                  co["vec_off"]:co["vec_off"] + spec.dim] = np.asarray(vec, np.float32)
    store.graph_buf[co["gid_block"], co["gid_off"]] = gid

    col = MT_OV_A if side == 0 else MT_OV_B
    for q in (pid, partner):
        if q < spec.n_partitions:
            store.meta_table[q, col] += 1
    return slot


def overflow_write_coords(spec: LayoutSpec, group: int, slot: int) -> dict:
    """Buffer coordinates of one overflow slot (device scatter uses the
    same numbers — ``device_store.overflow_append``)."""
    ov_blk = group * spec.group_blocks + spec.data_blocks
    vpos = slot * spec.dim
    return {
        "vec_block": ov_blk + vpos // spec.vblk,
        "vec_off": vpos % spec.vblk,
        "gid_block": ov_blk + slot // spec.gblk,
        "gid_off": slot % spec.gblk,
    }


def partition_gids(store: Store, pid: int) -> np.ndarray:
    """Global ids of the base (graph) vectors of ``pid``."""
    spec = store.spec
    row = store.meta_table[pid]
    side, group = int(row[MT_SIDE]), int(row[MT_GROUP])
    data_blk = group * spec.group_blocks + (
        0 if side == 0 else spec.data_blocks + spec.ov_blocks)
    gflat = store.graph_buf[data_blk:data_blk + spec.data_blocks].reshape(-1)
    gids = gflat[spec.np_max * spec.deg: spec.np_max * (spec.deg + 1)]
    return gids[: int(row[MT_N_BASE])].copy()


def partition_row_bytes(store: Store, pids) -> int:
    """The bytes the rows of partitions ``pids`` hold in the region: each
    base row's graph entry (``deg`` neighbours and its global id, int32)
    and vector (float32), and each overflow row in use in its group
    (global id and vector).  Not the padding of a span to ``np_max`` nor
    the empty overflow slots."""
    spec = store.spec
    mt = store.meta_table[np.asarray(pids).reshape(-1)].astype(np.int64)
    row = spec.dim * 4
    return int((mt[:, MT_N_BASE] * ((spec.deg + 1) * 4 + row)
                + (mt[:, MT_OV_A] + mt[:, MT_OV_B]) * (4 + row)).sum())


def overflow_gids(store: Store, pid: int) -> np.ndarray:
    """Global ids of ``pid``'s live overflow inserts (its side only)."""
    spec = store.spec
    row = store.meta_table[pid]
    side, group = int(row[MT_SIDE]), int(row[MT_GROUP])
    ov_blk = group * spec.group_blocks + spec.data_blocks
    gflat = store.graph_buf[ov_blk:ov_blk + spec.ov_blocks].reshape(-1)
    if side == 0:
        return gflat[: int(row[MT_OV_A])].copy()
    cb = int(row[MT_OV_B])
    return gflat[spec.ov_cap - cb: spec.ov_cap][::-1].copy() if cb else gflat[:0]


# ------------------------------------------------------ quantized mirror

def attach_quant_mirror(store: Store, group: int = 32) -> Store:
    """Build (or rebuild) the int8 mirror of ``vec_buf`` in place.

    ``group`` must divide ``dim`` (codec groups never straddle vectors).
    The mirror lives in the same registered region — quantized span
    fetches reuse ``fetch_span``/``span_block_ids`` verbatim.
    """
    from repro_torch.quant.codec import quantize_blocks
    spec = store.spec
    if spec.dim % group != 0:
        raise ValueError(f"quant group {group} must divide dim {spec.dim}")
    if spec.quant_group != group:
        import dataclasses as DC
        store.spec = DC.replace(spec, quant_group=group)
    qb = quantize_blocks(store.vec_buf, group)
    store.qvec_buf = qb.codes
    store.qscale_buf = qb.scales
    return store


def refresh_quant_blocks(store: Store, block_ids) -> None:
    """Re-quantize specific blocks after their vec rows changed (insert /
    repack touched them).  No-op when no mirror is attached."""
    if store.qvec_buf is None:
        return
    from repro_torch.quant.codec import quantize_groups
    ids = np.atleast_1d(np.asarray(block_ids, np.int64))
    codes, scales = quantize_groups(store.vec_buf[ids],
                                    store.spec.quant_group)
    store.qvec_buf[ids] = codes
    store.qscale_buf[ids] = scales


def refresh_quant_group(store: Store, group: int) -> None:
    """Re-quantize every block of one partition group (post-repack)."""
    if store.qvec_buf is None:
        return
    spec = store.spec
    start = group * spec.group_blocks
    refresh_quant_blocks(store, np.arange(start, start + spec.group_blocks))


def flat_quant_rows(store: Store):
    """Flat-database view of every LIVE vector row in the region.

    Returns ``(rows, gids, pids)`` — region row addresses (indices into
    ``vec_buf.reshape(-1, dim)`` and the lockstep quantized mirror), the
    matching global ids, and the owning partition of each row.  Base rows
    come first per partition, then that partition's live overflow slots
    (same order as ``overflow_gids``).  Every live row appears exactly
    once: a group's shared overflow region is split between the two
    partners by side, so the flat view never duplicates an insert.

    This is the compute-side index for the dense-resident stage-1 path:
    when the quantized tier can hold every partition, stage 1 is one flat
    ``quant_topk`` scan over these rows instead of per-pair decodes.
    """
    spec = store.spec
    rows, gids, pids = [], [], []
    for pid in range(spec.n_partitions):
        mrow = store.meta_table[pid]
        side, group = int(mrow[MT_SIDE]), int(mrow[MT_GROUP])
        blk_start = int(mrow[MT_BLK_START])
        n = int(mrow[MT_N_BASE])
        data_row0 = (blk_start + side * spec.ov_blocks) * spec.slot_vecs
        rows.append(data_row0 + np.arange(n, dtype=np.int64))
        gids.append(partition_gids(store, pid).astype(np.int64))
        ov_row0 = (blk_start + (1 - side) * spec.data_blocks) * spec.slot_vecs
        og = overflow_gids(store, pid).astype(np.int64)
        if side == 0:
            orows = ov_row0 + np.arange(len(og), dtype=np.int64)
        else:
            # side B fills back-to-front; overflow_gids reverses, so the
            # row addresses walk down from the last slot in lockstep
            orows = ov_row0 + (spec.ov_cap - 1 - np.arange(len(og),
                                                          dtype=np.int64))
        rows.append(orows)
        gids.append(og)
        pids.append(np.full(n + len(og), pid, np.int64))
    return (np.concatenate(rows), np.concatenate(gids),
            np.concatenate(pids))


def repack_group(store: Store, group: int, data_lookup,
                 sub_params: Optional[HNSWParams] = None) -> bool:
    """Fold both partitions' overflow inserts into rebuilt sub-HNSWs and
    re-serialize the group in place (paper's offline re-pack).  Returns
    False if a merged partition no longer fits ``np_max`` (caller must do
    a full ``build_store`` rebuild with a larger pad)."""
    spec = store.spec
    members: dict[int, np.ndarray] = {}
    for side in (0, 1):
        pid = group * 2 + side
        if pid >= spec.n_partitions:
            continue
        ids = np.concatenate([partition_gids(store, pid),
                              overflow_gids(store, pid)])
        if len(ids) > spec.np_max:
            return False
        members[pid] = ids
    ov_blk = group * spec.group_blocks + spec.data_blocks
    store.graph_buf[ov_blk:ov_blk + spec.ov_blocks] = -1
    store.vec_buf[ov_blk:ov_blk + spec.ov_blocks] = 0.0
    for pid, ids in members.items():
        serialize_partition(store, pid, ids, data_lookup(ids), 0, sub_params)
        store.meta_table[pid, MT_OV_A] = 0
        store.meta_table[pid, MT_OV_B] = 0
    return True

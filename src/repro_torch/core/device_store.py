"""Device-side store in torch: fetched-span decode + per-partition search.

Port of ``repro/core/device_store.py``.  A fetch span is
``(fetch_blocks, gblk)`` int32 + ``(fetch_blocks, vblk)`` float32 (or int8
codes + ``(fetch_blocks, n_qgroups)`` f32 scales for the quantized tier);
every function here takes a leading batch of spans/pairs where the
reference ``vmap``s one.

Kept from the reference on purpose:
* padding pairs carry query index ``B``; JAX clamps that gather, torch
  would raise, so the index is clamped to ``B - 1`` (the lanes are masked);
* ``lax.top_k`` and ``jnp.argsort`` order ties by the lower index: every
  sort here is a stable ``argsort``;
* the serve paths compute ``sum((v - q)^2)``; negative row addresses are
  clamped to 0 before gathers (``maximum(rows, 0)``).

``write_slots``, ``write_slots_quant`` and the overflow-append twins
(``overflow_append``, ``overflow_append_quant``) update their tensors in
place (the reference returns new arrays and donates the old ones).

With the tracer on, a serve round's work is split into spans: one
``compute.serve.decode`` and one ``compute.serve.walk`` (the per-pair
walk or scan) a pair chunk, and one ``compute.serve.merge`` a call.

The graph paths walk each lane's sub-HNSW through ``kernels/beam_walk``:
one kernel launch a pair chunk on the card, the plain loop of
``search.batched_beam_search`` on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import search as S
from repro_torch.core.layout import (LayoutSpec, MT_BLK_START, MT_ENTRY,
                                     MT_N_BASE, MT_OV_A, MT_OV_B, MT_SIDE)
from repro_torch.obs.trace import TRACER

# pairs decoded at once in serve_and_merge: bounds the (pairs, rows, D)
# temporaries of a large round (~1 MB of f32 vectors per pair at the
# paper geometry) without changing any per-pair result
PAIR_CHUNK = 2048


class DecodedPartition(NamedTuple):
    vectors: torch.Tensor    # (n, np_max + ov_cap, D) base then overflow
    adjacency: torch.Tensor  # (n, 1, np_max, deg) local ids, -1 pad
    gids: torch.Tensor       # (n, np_max + ov_cap) global ids, -1 pad
    valid: torch.Tensor      # (n, np_max + ov_cap) base n + live overflow
    entry: torch.Tensor      # (n,) local entry id (the representative)


def _slice_rows(flat, start, length: int):
    """Per-lane ``flat[l, start[l] : start[l] + length]`` for flat (n, F)."""
    idx = start[:, None] + torch.arange(length, device=flat.device)
    return flat.gather(1, idx)


def decode_span(spec: LayoutSpec, g_span, v_span, meta_row) -> DecodedPartition:
    """g_span (n, fetch_blocks, gblk) i32; v_span (n, fetch_blocks, vblk)
    f32; meta_row (n, META_COLS) -> the n decoded partitions."""
    # vblk = slot_vecs * dim, so every vector offset is whole rows
    return _decode(spec, g_span, v_span.reshape(g_span.shape[0], -1,
                                                spec.dim), meta_row)


def _decode(spec: LayoutSpec, g_span, vrows, meta_row) -> DecodedPartition:
    """``decode_span`` on the span's vectors as (n, rows, D) f32."""
    n = g_span.shape[0]
    side = meta_row[:, MT_SIDE].long()
    n_base = meta_row[:, MT_N_BASE]
    gflat = g_span.reshape(n, -1)
    dev = g_span.device

    data_g = _slice_rows(gflat, side * spec.ov_blocks * spec.gblk,
                         spec.np_max * (spec.deg + 1))
    adjacency = data_g[:, : spec.np_max * spec.deg].reshape(
        n, spec.np_max, spec.deg)
    base_gids = data_g[:, spec.np_max * spec.deg:]
    ov_gids = _slice_rows(gflat, (1 - side) * spec.data_blocks * spec.gblk,
                          spec.ov_cap)

    lanes = torch.arange(n, device=dev)[:, None]
    base_row0 = side * spec.ov_blocks * spec.slot_vecs
    ov_row0 = (1 - side) * spec.data_blocks * spec.slot_vecs
    base_vecs = vrows[lanes, base_row0[:, None]
                      + torch.arange(spec.np_max, device=dev)]
    ov_vecs = vrows[lanes, ov_row0[:, None]
                    + torch.arange(spec.ov_cap, device=dev)]

    cnt_a, cnt_b = meta_row[:, MT_OV_A], meta_row[:, MT_OV_B]
    ov_idx = torch.arange(spec.ov_cap, device=dev)[None, :]
    # A's inserts fill the front, B's fill the back; a fetch sees both but
    # only its own side's slots belong to this partition
    ov_mine = torch.where(side[:, None] == 0, ov_idx < cnt_a[:, None],
                          ov_idx >= spec.ov_cap - cnt_b[:, None])
    base_valid = (torch.arange(spec.np_max, device=dev)[None, :]
                  < n_base[:, None])
    return DecodedPartition(
        vectors=torch.cat([base_vecs, ov_vecs], dim=1),
        adjacency=adjacency[:, None],
        gids=torch.cat([base_gids, ov_gids], dim=1),
        valid=torch.cat([base_valid, ov_mine], dim=1),
        entry=meta_row[:, MT_ENTRY].long(),
    )


def search_decoded_scan(part: DecodedPartition, q, k: int):
    """Exact top-k over every valid vector (base + overflow) of each lane.
    q (n, D) -> (dists (n, k), global ids (n, k))."""
    d = (part.vectors - q[:, None, :]).square().sum(-1)
    d = torch.where(part.valid, d, S.INF)
    nd, ni = S.topk_smallest(d, k)
    return nd, part.gids.gather(1, ni)


def _walk(part: DecodedPartition, q, ef: int):
    """Each lane's beam walk over its base graph (``kernels/beam_walk``,
    imported here: a memory node imports this module and no kernel)."""
    from repro_torch.kernels.beam_walk.ops import beam_walk
    np_max = part.adjacency.shape[2]
    return beam_walk(part.vectors[:, :np_max], part.adjacency[:, 0], q,
                     part.entry, ef=ef)


def search_decoded_graph(part: DecodedPartition, q, k: int, ef: int):
    """Paper-faithful: beam-search each lane's sub-HNSW over its base
    vectors, brute-scan the live overflow slice, and merge."""
    np_max = part.adjacency.shape[2]
    bd, bi = _walk(part, q, max(ef, k))
    safe = bi.clamp(0, part.valid.shape[1] - 1)    # JAX clamps the gather
    bd = torch.where((bi >= 0) & part.valid.gather(1, safe), bd, S.INF)
    base_d = bd[:, :k]
    base_i = torch.where(torch.isfinite(base_d),
                         part.gids.gather(1, safe[:, :k]), -1)
    ov_vecs = part.vectors[:, np_max:]
    ov_d = (ov_vecs - q[:, None, :]).square().sum(-1)
    ov_d = torch.where(part.valid[:, np_max:], ov_d, S.INF)
    kk = min(k, ov_vecs.shape[1])
    od, oi = S.topk_smallest(ov_d, kk)
    og = part.gids.gather(1, np_max + oi)
    return S.merge_topk(base_d, base_i, od,
                        torch.where(torch.isfinite(od), og, -1), k)


def serve_and_merge(spec: LayoutSpec, cache_g, cache_v, meta_table, queries,
                    run_d, run_g, pair_qi, pair_pids, pair_slots, pair_ranks,
                    pair_valid, *, k: int, ef: int, mode: str, n_lanes: int):
    """One round: per-pair top-k inside the pair's cached partition, then
    one scatter-merge into the batch's running (B, k) top-k.

    pair_qi: (n_pairs,) query index; padding lanes point at row B (the
    merge's dump row).  pair_ranks: merge lane of each pair (unique per
    (query, round)).  Returns the updated (run_d, run_g)."""
    B = queries.shape[0]
    ds, gs = [], []
    for c0 in range(0, pair_qi.shape[0], PAIR_CHUNK):
        sl = slice(c0, c0 + PAIR_CHUNK)
        with TRACER.span("compute.serve.decode", tier="compute"):
            slots = pair_slots[sl].long()
            rows = meta_table[pair_pids[sl].long()]
            qs = queries[pair_qi[sl].long().clamp(max=B - 1)]
            part = decode_span(spec, cache_g[slots], cache_v[slots], rows)
        with TRACER.span("compute.serve.walk", tier="compute"):
            if mode == "graph":
                d, g = search_decoded_graph(part, qs, k, ef)
            else:
                d, g = search_decoded_scan(part, qs, k)
        ok = pair_valid[sl][:, None]
        ds.append(torch.where(ok, d, S.INF))
        gs.append(torch.where(ok, g, -1))
    with TRACER.span("compute.serve.merge", tier="compute"):
        return merge_ranked(run_d, run_g, pair_qi, pair_ranks,
                            torch.cat(ds), torch.cat(gs), n_lanes=n_lanes)


def merge_ranked(run_d, run_g, pair_qi, pair_ranks, d, g, *, n_lanes: int):
    """Scatter per-pair top-k lists into lane ``(pair_qi, pair_ranks)`` of a
    ``(B+1, n_lanes, k)`` buffer (row B is the dump row for padding pairs),
    then take each query's new top-k with one stable argsort.  Equivalent
    to folding the pairs through sequential stable merges."""
    nd, ng = merge_ranked_payload(run_d, run_g[..., None], pair_qi,
                                  pair_ranks, d, g[..., None],
                                  n_lanes=n_lanes)
    return nd, ng[..., 0]


def merge_ranked_payload(run_d, run_p, pair_qi, pair_ranks, d, p, *,
                         n_lanes: int):
    """``merge_ranked`` with a (..., P) int payload instead of one id
    column: the same (B+1, n_lanes, m) scatter and one stable argsort per
    query, so round grouping never changes the merged result.
    run_d (B, m), run_p (B, m, P); d (n_pairs, m), p (n_pairs, m, P)."""
    B, m = run_d.shape
    P = run_p.shape[2]
    buf_d = run_d.new_full((B + 1, n_lanes, m), S.INF)
    buf_p = run_p.new_full((B + 1, n_lanes, m, P), -1)
    qi, rk = pair_qi.long(), pair_ranks.long()
    buf_d[qi, rk] = d.to(run_d.dtype)
    buf_p[qi, rk] = p.to(run_p.dtype)
    all_d = torch.cat([run_d, buf_d[:B].reshape(B, n_lanes * m)], dim=1)
    all_p = torch.cat([run_p, buf_p[:B].reshape(B, n_lanes * m, P)], dim=1)
    order = torch.argsort(all_d, dim=1, stable=True)[:, :m]
    return all_d.gather(1, order), all_p.gather(
        1, order[:, :, None].expand(-1, -1, P))


# ------------------------------------------------------------ quantized tier
#
# The staged (quant=int8) search: stage 1 decodes QUANTIZED spans resident
# in the large quantized tier into the same DecodedPartition view
# (dequantize = one multiply) and pools per-query candidates (distance,
# gid, exact-row address, pid); stage 2 gathers only the candidate rows in
# full precision and re-ranks to the final top-k.

def decode_quant_span(spec: LayoutSpec, g_span, qv_span, qs_span, meta_row):
    """Quantized twin of ``decode_span``.

    g_span (n, fetch_blocks, gblk) i32; qv_span (n, fetch_blocks, vblk)
    int8; qs_span (n, fetch_blocks, n_qgroups) f32; meta_row (n,
    META_COLS).  Returns (DecodedPartition with dequantized f32 vectors,
    rows (n, np_max + ov_cap) i32): ``rows`` are exact-row addresses into
    ``vec_buf.reshape(-1, dim)``, what stage 2 fetches for re-ranking."""
    n = g_span.shape[0]
    g = spec.quant_group
    # the whole span dequantized as the reference dequantizes each slice:
    # codes.reshape(-1, g) * scales[:, None] in f32
    codes = qv_span.reshape(n, -1, g).to(torch.float32)
    vrows = (codes * qs_span.reshape(n, -1)[:, :, None]).reshape(
        n, -1, spec.dim)
    part = _decode(spec, g_span, vrows, meta_row)
    # exact-row addresses: vblk = slot_vecs * dim, so row r of the region
    # lives at flat row index block * slot_vecs + local offset
    side = meta_row[:, MT_SIDE]
    blk_start = meta_row[:, MT_BLK_START]
    data_row0 = (blk_start + side * spec.ov_blocks) * spec.slot_vecs
    ov_row0 = (blk_start + (1 - side) * spec.data_blocks) * spec.slot_vecs
    dev = g_span.device
    rows = torch.cat([
        data_row0[:, None] + torch.arange(spec.np_max, device=dev),
        ov_row0[:, None] + torch.arange(spec.ov_cap, device=dev)],
        dim=1).to(torch.int32)
    return part, rows


def _pad_topk(d, i, k: int):
    """Pad (n, kk) top lists to (n, k) with inf/-1 when kk < k."""
    kk = d.shape[1]
    if kk >= k:
        return d[:, :k], i[:, :k]
    pad = k - kk
    return (torch.cat([d, d.new_full((d.shape[0], pad), S.INF)], 1),
            torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1))


def search_decoded_scan_local(part: DecodedPartition, q, k: int):
    """Like ``search_decoded_scan`` but returns LOCAL indices (int32; the
    candidate pool needs them to derive exact-row addresses)."""
    n = part.vectors.shape[1]
    d = (part.vectors - q[:, None, :]).square().sum(-1)
    d = torch.where(part.valid, d, S.INF)
    nd, ni = S.topk_smallest(d, min(k, n))
    return _pad_topk(nd, ni.to(torch.int32), k)


def search_decoded_graph_local(part: DecodedPartition, q, k: int, ef: int):
    """Like ``search_decoded_graph`` but returns LOCAL indices (int32):
    each lane's beam walk over its base graph + a brute scan of its live
    overflow slice."""
    np_max = part.adjacency.shape[2]
    bd, bi = _walk(part, q, max(ef, k))
    bd = torch.where((bi >= 0) & part.valid.gather(
        1, bi.clamp(0, part.valid.shape[1] - 1)), bd, S.INF)
    ov_d = (part.vectors[:, np_max:] - q[:, None, :]).square().sum(-1)
    ov_d = torch.where(part.valid[:, np_max:], ov_d, S.INF)
    all_d = torch.cat([bd, ov_d], dim=1)
    ov_i = np_max + torch.arange(ov_d.shape[1], dtype=torch.int32,
                                 device=q.device)
    all_i = torch.cat([bi.to(torch.int32),
                       ov_i.expand(q.shape[0], -1)], dim=1)
    nd, pos = S.topk_smallest(all_d, min(k, all_d.shape[1]))
    return _pad_topk(nd, all_i.gather(1, pos), k)


def serve_quant_pool(spec: LayoutSpec, cache_qg, cache_qv, cache_qs,
                     meta_table, queries, pool_d, pool_p, pair_qi, pair_pids,
                     pair_slots, pair_ranks, pair_valid, *, m: int, ef: int,
                     mode: str, n_lanes: int):
    """Stage-1 round: per-pair top-m inside the pair's QUANTIZED partition,
    then one scatter-merge into the batch's running candidate pool.
    ``pool_d`` (B, m) distances; ``pool_p`` (B, m, 3) int32 payload columns
    [gid, exact_row, pid] carried through the merge.  Pairs are decoded
    ``PAIR_CHUNK`` at a time, as in ``serve_and_merge``.  Returns the
    updated (pool_d, pool_p)."""
    B = queries.shape[0]
    ds, ps = [], []
    for c0 in range(0, pair_qi.shape[0], PAIR_CHUNK):
        sl = slice(c0, c0 + PAIR_CHUNK)
        with TRACER.span("compute.serve.decode", tier="compute"):
            slots = pair_slots[sl].long()
            pids = pair_pids[sl]
            qs = queries[pair_qi[sl].long().clamp(max=B - 1)]
            part, rows = decode_quant_span(spec, cache_qg[slots],
                                           cache_qv[slots], cache_qs[slots],
                                           meta_table[pids.long()])
        with TRACER.span("compute.serve.walk", tier="compute"):
            if mode == "graph":
                d, li = search_decoded_graph_local(part, qs, m, ef)
            else:
                d, li = search_decoded_scan_local(part, qs, m)
        live = (li >= 0) & pair_valid[sl][:, None] & torch.isfinite(d)
        safe = li.long().clamp(0, part.gids.shape[1] - 1)
        payload = torch.stack([part.gids.gather(1, safe),
                               rows.gather(1, safe),
                               pids[:, None].expand_as(li)],
                              dim=-1).to(torch.int32)
        ds.append(torch.where(live, d, S.INF))
        ps.append(torch.where(live[:, :, None], payload, -1))
    with TRACER.span("compute.serve.merge", tier="compute"):
        return merge_ranked_payload(pool_d, pool_p, pair_qi, pair_ranks,
                                    torch.cat(ds), torch.cat(ps),
                                    n_lanes=n_lanes)


# ------------------------------------------------ rows and cache slots

def gather_rows(vec_buf, rows, *, dim: int):
    """The pool's row-granular READ: exact vector rows by region row
    address into ``vec_buf.reshape(-1, dim)`` (-1 lanes gather row 0 and
    are masked by the caller).  Returns (..., D) f32."""
    return vec_buf.reshape(-1, dim)[rows.long().clamp(min=0)]


def rerank_gathered(vrows, queries, rows, gids, *, k: int):
    """Stage 2: exact distances over the gathered candidate rows.  rows
    (B, m) mark empty lanes with -1; gids (B, m).  Returns the final
    (dists (B, k), gids (B, k))."""
    d = (vrows - queries[:, None, :]).square().sum(-1)
    d = torch.where(rows >= 0, d, S.INF)
    nd, ni = S.topk_smallest(d, k)
    g = gids.gather(1, ni)
    return nd, torch.where(torch.isfinite(nd), g, -1)


def gather_quant_rows(qvec_buf, qscale_buf, rows, *, dim: int, group: int):
    """Row-granular gather from the quantized mirror: int8 codes plus the
    per-row codebook scales, by the same region row addresses."""
    safe = rows.long().clamp(min=0)
    codes = qvec_buf.reshape(-1, dim)[safe]
    scales = qscale_buf.reshape(-1, dim // group)[safe]
    return codes, scales


def write_slots(spec: LayoutSpec, cache_g, cache_v, slot_ids, g_blocks,
                v_blocks):
    """Install fetched spans into cache slots, in place.
    g_blocks: (n_fetch, fetch_blocks, gblk); slot_ids: (n_fetch,)."""
    slots = slot_ids.long()
    cache_g[slots] = g_blocks
    cache_v[slots] = v_blocks
    return cache_g, cache_v


def write_slots_quant(spec: LayoutSpec, cache_qg, cache_qv, cache_qs,
                      slot_ids, g_blocks, qv_blocks, qs_blocks):
    """Install fetched QUANTIZED spans into quant-tier slots, in place."""
    slots = slot_ids.long()
    cache_qg[slots] = g_blocks
    cache_qv[slots] = qv_blocks
    cache_qs[slots] = qs_blocks
    return cache_qg, cache_qv, cache_qs


def overflow_append(spec: LayoutSpec, graph_buf, vec_buf, vec, gid,
                    vec_block, vec_off, gid_block, gid_off):
    """Device twin of ``layout.insert_vector``: one-slot scatter into the
    shared overflow region, in place (coords from
    ``overflow_write_coords``)."""
    vec_buf[vec_block, vec_off:vec_off + spec.dim] = vec
    graph_buf[gid_block, gid_off] = gid
    return graph_buf, vec_buf


def overflow_append_quant(spec: LayoutSpec, qvec_buf, qscale_buf, vec,
                          vec_block, vec_off):
    """Device twin of the quantized mirror update for one overflow insert:
    quantize the row on the device and scatter its codes and codebook
    scales in place (coords from ``layout.overflow_write_coords``)."""
    from repro_torch.quant.codec import quantize_row_torch
    g = spec.quant_group
    codes, scales = quantize_row_torch(vec, g)
    qvec_buf[vec_block, vec_off:vec_off + spec.dim] = codes
    qscale_buf[vec_block, vec_off // g:vec_off // g + spec.dim // g] = scales
    return qvec_buf, qscale_buf

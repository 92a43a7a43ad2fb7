"""Device-side store in torch: fetched-span decode + per-partition search.

Port of the exact half of ``repro/core/device_store.py`` plus the pieces
the int8 flat route needs (row gathers and the stage-2 re-rank).  A fetch
span is ``(fetch_blocks, gblk)`` int32 + ``(fetch_blocks, vblk)`` float32;
every function here takes a leading batch of spans/pairs where the
reference ``vmap``s one.

Kept from the reference on purpose:
* padding pairs carry query index ``B``; JAX clamps that gather, torch
  would raise, so the index is clamped to ``B - 1`` (the lanes are masked);
* ``lax.top_k`` and ``jnp.argsort`` order ties by the lower index: every
  sort here is a stable ``argsort``;
* the serve paths compute ``sum((v - q)^2)``; negative row addresses are
  clamped to 0 before gathers (``maximum(rows, 0)``).

``write_slots`` updates the cache tensors in place (the reference returns
new arrays and donates the old ones).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import search as S
from repro_torch.core.layout import (LayoutSpec, MT_ENTRY, MT_N_BASE,
                                     MT_OV_A, MT_OV_B, MT_SIDE)

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
    n = g_span.shape[0]
    side = meta_row[:, MT_SIDE].long()
    n_base = meta_row[:, MT_N_BASE]
    gflat = g_span.reshape(n, -1)
    # vblk = slot_vecs * dim, so every vector offset is whole rows
    vrows = v_span.reshape(n, -1, spec.dim)
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


def search_decoded_graph(part: DecodedPartition, q, k: int, ef: int):
    """Paper-faithful: beam-search each lane's sub-HNSW over its base
    vectors, brute-scan the live overflow slice, and merge."""
    np_max = part.adjacency.shape[2]
    bd, bi = S.batched_beam_search(part.vectors[:, :np_max], part.adjacency,
                                   q, part.entry, ef=max(ef, k), n_levels=1)
    safe = bi.clamp(min=0)
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
        slots = pair_slots[sl].long()
        rows = meta_table[pair_pids[sl].long()]
        qs = queries[pair_qi[sl].long().clamp(max=B - 1)]
        part = decode_span(spec, cache_g[slots], cache_v[slots], rows)
        if mode == "graph":
            d, g = search_decoded_graph(part, qs, k, ef)
        else:
            d, g = search_decoded_scan(part, qs, k)
        ok = pair_valid[sl][:, None]
        ds.append(torch.where(ok, d, S.INF))
        gs.append(torch.where(ok, g, -1))
    return merge_ranked(run_d, run_g, pair_qi, pair_ranks, torch.cat(ds),
                        torch.cat(gs), n_lanes=n_lanes)


def merge_ranked(run_d, run_g, pair_qi, pair_ranks, d, g, *, n_lanes: int):
    """Scatter per-pair top-k lists into lane ``(pair_qi, pair_ranks)`` of a
    ``(B+1, n_lanes, k)`` buffer (row B is the dump row for padding pairs),
    then take each query's new top-k with one stable argsort.  Equivalent
    to folding the pairs through sequential stable merges."""
    B, k = run_d.shape
    buf_d = run_d.new_full((B + 1, n_lanes, k), S.INF)
    buf_g = run_g.new_full((B + 1, n_lanes, k), -1)
    qi, rk = pair_qi.long(), pair_ranks.long()
    buf_d[qi, rk] = d.to(run_d.dtype)
    buf_g[qi, rk] = g.to(run_g.dtype)
    all_d = torch.cat([run_d, buf_d[:B].reshape(B, n_lanes * k)], dim=1)
    all_g = torch.cat([run_g, buf_g[:B].reshape(B, n_lanes * k)], dim=1)
    order = torch.argsort(all_d, dim=1, stable=True)[:, :k]
    return all_d.gather(1, order), all_g.gather(1, order)


# ------------------------------------------------------- int8 flat route

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

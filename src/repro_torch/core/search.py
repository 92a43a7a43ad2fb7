"""Batched HNSW search in torch (greedy descent + ef beam at layer 0).

Port of ``repro/core/search.py``.  The reference runs one query's walk in
a ``lax.while_loop`` and ``vmap``s it over the batch; here the batch is a
leading dimension written out and each walk is ONE batched Python loop
that runs while any lane is still active and updates only the active
lanes, with the reference's stop rule (``max_iters = 2*ef + 8`` beam
steps, ``max_hops = 64`` per descent layer).  A lane that stops never
restarts, so its state is final the moment it stops.

``vectors`` / ``adjacency`` are either shared by every lane (the cached
meta-HNSW: ``(N, D)`` and ``(L, N, deg)``) or per lane (fetched
partitions: ``(B, N, D)`` and ``(B, L, N, deg)``).

Reference behaviour kept on purpose: stable sorts everywhere (ties to
the lower index, as ``jnp.argsort`` and ``lax.top_k`` order them), and
the visited-bitmap scatter that marks node 0 for every neighbour that is
not fresh (``search.py:104-105``), so node 0 is skipped after the first
expansion that meets a visited or padded neighbour.  And JAX's
out-of-bounds indexing: a neighbour id past the lane's nodes (a
partition's adjacency after an insert can decode one: the overflow
slot's gid written into the span's graph block) is clamped to the last
node where it is read (its vector, its row, its visited bit) and
dropped where the visited bitmap is written.

With the tracer on, every beam step and descent hop counts one
``walk_steps`` (``route_steps`` for the meta-HNSW), and each loop's
``bool(active.any())``, the host's one wait for the card a step, is
timed as a host sync (site ``walk``, ``route``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.trace import TRACER

INF = float("inf")


def _lanes(t: torch.Tensor, B: int) -> torch.Tensor:
    return torch.arange(B, device=t.device)


def _sq_dists(vectors, ids, q):
    """Squared L2 from q (B, D) to vectors[ids] for ids (B, n); invalid ids
    (<0) -> inf.  ``vectors`` is (N, D) shared or (B, N, D) per lane."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long().clamp(max=vectors.shape[-2] - 1)
    if vectors.dim() == 3:
        rows = vectors[_lanes(ids, ids.shape[0])[:, None], safe]
    else:
        rows = vectors[safe]
    d = (rows - q[:, None, :]).square().sum(-1)
    return torch.where(valid, d, INF)


def _layer(adjacency, layer: int):
    """The (·, N, deg) adjacency of one layer, shared or per lane."""
    return adjacency[:, layer] if adjacency.dim() == 4 else adjacency[layer]


def _neighbours(adj_layer, u):
    """Neighbour rows (B, deg) of nodes u (B,) (u clamped to the last
    row, as a JAX gather clamps it)."""
    u = u.clamp(max=adj_layer.shape[-2] - 1)
    if adj_layer.dim() == 3:
        return adj_layer[_lanes(u, u.shape[0]), u]
    return adj_layer[u]


def _entry_dist(vectors, q, entry):
    if vectors.dim() == 3:
        rows = vectors[_lanes(entry, entry.shape[0]), entry]
    else:
        rows = vectors[entry]
    return (rows - q).square().sum(-1)


def greedy_descent(vectors, adjacency, q, entry, n_levels: int,
                   max_hops: int = 64, *, steps: str = "walk_steps",
                   site: str = "walk"):
    """Layers top..1: hill-climb each lane to its locally closest node.
    q (B, D), entry (B,) -> (node (B,), dist (B,)).  ``steps`` / ``site``:
    the tracer's names for the hops and the per-hop sync."""
    u = entry.long()
    du = _entry_dist(vectors, q, u)
    for l_rev in range(n_levels - 1):
        adj = _layer(adjacency, n_levels - 1 - l_rev)   # top .. 1
        active = torch.ones_like(u, dtype=torch.bool)
        hops = 0
        while hops < max_hops:
            with TRACER.wait(site):
                go = bool(active.any())
            if not go:
                break
            TRACER.count(steps)
            nbrs = _neighbours(adj, u)
            d = _sq_dists(vectors, nbrs, q)
            j = torch.argmin(d, dim=1, keepdim=True)
            dj = d.gather(1, j)[:, 0]
            better = active & (dj < du)
            u = torch.where(better, nbrs.gather(1, j)[:, 0].long(), u)
            du = torch.where(better, dj, du)
            active = better
            hops += 1
    return u, du


def batched_beam_search(vectors, adjacency, queries, entry, *, ef: int,
                        n_levels: int = 1, max_iters: Optional[int] = None,
                        visited_size: Optional[int] = None,
                        steps: str = "walk_steps", site: str = "walk"):
    """Full HNSW query for a batch: queries (B, D) -> (B, ef) dists/ids,
    ascending, inf/-1 padded.  ``entry`` is an int or (B,).  ``steps`` /
    ``site``: the tracer's names for the steps and the per-step sync."""
    B = queries.shape[0]
    dev = queries.device
    n = vectors.shape[-2] if visited_size is None else visited_size
    max_iters = max_iters or (2 * ef + 8)
    if not torch.is_tensor(entry) or entry.dim() == 0:
        entry = torch.full((B,), int(entry), dtype=torch.long, device=dev)
    lanes = torch.arange(B, device=dev)
    adj0 = _layer(adjacency, 0)

    ep, dep = greedy_descent(vectors, adjacency, queries, entry, n_levels,
                             steps=steps, site=site)
    beam_d = torch.full((B, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = dep
    beam_i = torch.full((B, ef), -1, dtype=torch.long, device=dev)
    beam_i[:, 0] = ep
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    # column n: where the writes at ids past the nodes go (JAX drops them)
    visited = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    visited[lanes, ep] = True

    it = 0
    while it < max_iters:
        live = beam_i >= 0
        cand = torch.where(~expanded & live, beam_d, INF)
        best_un = cand.min(dim=1).values
        worst = torch.where(live, beam_d, -INF).max(dim=1).values
        active = torch.isfinite(best_un) & (best_un <= worst)
        with TRACER.wait(site):
            go = bool(active.any())
        if not go:
            break
        TRACER.count(steps)
        pos = torch.argmin(cand, dim=1, keepdim=True)
        u = beam_i.gather(1, pos)[:, 0].clamp(min=0)
        exp_new = expanded.scatter(1, pos, True)

        nbrs = _neighbours(adj0, u).long()                  # (B, deg)
        ok = nbrs >= 0
        seen = visited.gather(1, torch.where(ok, nbrs, 0).clamp(max=n - 1))
        fresh = ok & ~seen & active[:, None]
        visited.scatter_(1, torch.where(fresh, nbrs, 0).clamp(max=n), True)
        nd = torch.where(fresh, _sq_dists(vectors, nbrs, queries), INF)

        all_d = torch.cat([beam_d, nd], dim=1)
        all_i = torch.cat([beam_i, torch.where(fresh, nbrs, -1)], dim=1)
        all_e = torch.cat([exp_new, torch.zeros_like(fresh)], dim=1)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :ef]
        a = active[:, None]
        beam_d = torch.where(a, all_d.gather(1, order), beam_d)
        beam_i = torch.where(a, all_i.gather(1, order), beam_i)
        expanded = torch.where(a, all_e.gather(1, order), expanded)
        it += 1
    return beam_d, beam_i


def beam_search(vectors, adjacency, q, entry, *, ef: int,
                n_levels: int = 1, max_iters: Optional[int] = None,
                visited_size: Optional[int] = None):
    """One query: q (D,) -> (dists (ef,), ids (ef,)) ascending."""
    d, i = batched_beam_search(vectors, adjacency, q[None], entry, ef=ef,
                               n_levels=n_levels, max_iters=max_iters,
                               visited_size=visited_size)
    return d[0], i[0]


# ------------------------------------------------------------- meta routing

def meta_route(meta_vectors, meta_adjacency, queries, entry, *, b: int,
               ef: int = 0, n_levels: int = 3):
    """Route a batch of queries through the cached meta-HNSW.

    Returns (B, b) partition ids (= L0 rep indices, int32), nearest-first,
    and their distances."""
    ef = max(ef, 2 * b, 8)
    d, i = batched_beam_search(meta_vectors, meta_adjacency, queries, entry,
                               ef=ef, n_levels=n_levels, steps="route_steps",
                               site="route")
    return i[:, :b].to(torch.int32), d[:, :b]


# ------------------------------------------------------------- scan mode

def topk_smallest(d, k: int):
    """The k smallest along the last axis, ascending, ties to the lower
    index — ``lax.top_k(-d, k)``'s result, negated back."""
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return d.gather(-1, order), order


def scan_partition(part_vectors, q, k: int, n_valid=None):
    """Exact top-k within one loaded partition ((Np, D) padded)."""
    d = (part_vectors - q[None, :]).square().sum(-1)
    if n_valid is not None:
        rows = torch.arange(d.shape[0], device=d.device)
        d = torch.where(rows < n_valid, d, INF)
    return topk_smallest(d, k)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two sorted top-k lists (stable: list a wins ties)."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return d.gather(-1, order), i.gather(-1, order)

"""Host-side HNSW construction (numpy) — the graph the paper disaggregates.

Standard Malkov–Yashunin HNSW: exponentially-distributed insert levels,
per-layer greedy descent to the insert point, ``efConstruction`` beam at
the base layer, neighbor-set pruning with the distance heuristic.  This is
the *build* path only; it runs on the host (the paper builds the index on
the memory-pool loader before serving).  Query-time search lives in
``core/search.py`` as fixed-shape JAX.

Export format (``PaddedGraph``) is the dense -1-padded adjacency the JAX
search and the RDMA-friendly layout (``core/layout.py``) both consume.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def l2_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 between one vector ``a`` (D,) and rows of ``b`` (N, D)."""
    d = b - a[None, :]
    return np.einsum("nd,nd->n", d, d)


@dataclass
class HNSWParams:
    M: int = 16              # max degree at layers > 0
    M0: int = 32             # max degree at layer 0 (2*M, standard)
    ef_construction: int = 100
    ml: float = 0.0          # level multiplier; 0 -> 1/ln(M)
    seed: int = 0
    heuristic: bool = True   # neighbor-selection distance heuristic

    def __post_init__(self):
        if self.ml == 0.0:
            self.ml = 1.0 / math.log(self.M)


@dataclass
class PaddedGraph:
    """Dense export: fixed shapes, -1 padding — directly device-puttable."""

    vectors: np.ndarray        # (N, D) f32
    adjacency: np.ndarray      # (L, N, deg) i32, -1 padded; L = n_levels
    entry: int                 # entry node id (top level)
    n_levels: int
    node_level: np.ndarray     # (N,) i32 max level of each node

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


class HNSW:
    """Incremental HNSW over float32 vectors with squared-L2 metric."""

    def __init__(self, dim: int, params: Optional[HNSWParams] = None):
        self.p = params or HNSWParams()
        self.dim = dim
        self.vectors: list[np.ndarray] = []
        self.levels: list[int] = []
        # neighbors[l][i] = list of node ids at layer l (only for i with level >= l)
        self.neighbors: list[list[list[int]]] = []
        self.entry: int = -1
        self.max_level: int = -1
        self._rng = np.random.default_rng(self.p.seed)
        self._mat: Optional[np.ndarray] = None  # lazily rebuilt (N, D) matrix

    # ------------------------------------------------------------ build

    def _matrix(self) -> np.ndarray:
        if self._mat is None or self._mat.shape[0] != len(self.vectors):
            self._mat = (np.stack(self.vectors) if self.vectors
                         else np.zeros((0, self.dim), np.float32))
        return self._mat

    def _draw_level(self) -> int:
        return int(-math.log(max(self._rng.random(), 1e-12)) * self.p.ml)

    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      layer: int) -> list[tuple[float, int]]:
        """Beam search at one layer; returns sorted [(dist, id)] of <= ef."""
        mat = self._matrix()
        visited = {entry}
        d0 = float(l2_sq(q, mat[entry:entry + 1])[0])
        cand = [(d0, entry)]       # min-heap by dist (kept sorted, small ef)
        best = [(d0, entry)]       # result set, sorted ascending
        import heapq
        heapq.heapify(cand)
        while cand:
            d, u = heapq.heappop(cand)
            if d > best[-1][0] and len(best) >= ef:
                break
            nbrs = [v for v in self.neighbors[layer][u] if v not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            dists = l2_sq(q, mat[nbrs])
            worst = best[-1][0]
            for dv, v in zip(dists.tolist(), nbrs):
                if len(best) < ef or dv < worst:
                    heapq.heappush(cand, (dv, v))
                    best.append((dv, v))
                    best.sort()
                    if len(best) > ef:
                        best.pop()
                    worst = best[-1][0]
        return best

    def _select_neighbors(self, q: np.ndarray, cands: list[tuple[float, int]],
                          m: int) -> list[int]:
        """Distance heuristic (alg. 4 of the paper[20]): keep a candidate
        only if it is closer to q than to every already-kept neighbor."""
        if not self.p.heuristic or len(cands) <= m:
            return [i for _, i in sorted(cands)[:m]]
        mat = self._matrix()
        kept: list[int] = []
        for d, c in sorted(cands):
            if len(kept) >= m:
                break
            ok = True
            for k in kept:
                if float(l2_sq(mat[c], mat[k:k + 1])[0]) < d:
                    ok = False
                    break
            if ok:
                kept.append(c)
        # backfill with nearest pruned if underfull (keepPruned variant)
        if len(kept) < m:
            for d, c in sorted(cands):
                if c not in kept:
                    kept.append(c)
                    if len(kept) >= m:
                        break
        return kept

    def insert(self, vec: np.ndarray, level: Optional[int] = None) -> int:
        vec = np.asarray(vec, np.float32)
        nid = len(self.vectors)
        self.vectors.append(vec)
        self._mat = None
        lvl = self._draw_level() if level is None else level
        self.levels.append(lvl)
        while len(self.neighbors) <= lvl:
            self.neighbors.append([[] for _ in range(nid)])
        for layer in self.neighbors:
            while len(layer) <= nid:
                layer.append([])

        if self.entry < 0:
            self.entry, self.max_level = nid, lvl
            return nid

        ep = self.entry
        # greedy descent through layers above lvl
        for layer in range(self.max_level, lvl, -1):
            ep = self._search_layer(vec, ep, 1, layer)[0][1]
        # insert at layers min(lvl, max_level) .. 0
        for layer in range(min(lvl, self.max_level), -1, -1):
            cands = self._search_layer(vec, ep, self.p.ef_construction, layer)
            m = self.p.M0 if layer == 0 else self.p.M
            nbrs = self._select_neighbors(vec, cands, m)
            self.neighbors[layer][nid] = list(nbrs)
            mat = self._matrix()
            for v in nbrs:
                lst = self.neighbors[layer][v]
                lst.append(nid)
                if len(lst) > m:
                    cd = [(float(l2_sq(mat[v], mat[u:u + 1])[0]), u) for u in lst]
                    self.neighbors[layer][v] = self._select_neighbors(mat[v], cd, m)
            ep = cands[0][1]
        if lvl > self.max_level:
            self.entry, self.max_level = nid, lvl
        return nid

    def build(self, data: np.ndarray) -> "HNSW":
        for row in np.asarray(data, np.float32):
            self.insert(row)
        return self

    # ------------------------------------------------------------ query (host oracle)

    def search(self, q: np.ndarray, k: int, ef: int) -> list[tuple[float, int]]:
        if self.entry < 0:
            return []
        q = np.asarray(q, np.float32)
        ep = self.entry
        for layer in range(self.max_level, 0, -1):
            ep = self._search_layer(q, ep, 1, layer)[0][1]
        best = self._search_layer(q, ep, max(ef, k), 0)
        return best[:k]

    # ------------------------------------------------------------ export

    def export(self, max_levels: Optional[int] = None) -> PaddedGraph:
        n = len(self.vectors)
        n_levels = (self.max_level + 1 if max_levels is None
                    else min(self.max_level + 1, max_levels))
        deg = max(self.p.M0, self.p.M)
        adj = np.full((n_levels, n, deg), -1, np.int32)
        for l in range(n_levels):
            for i in range(n):
                nb = self.neighbors[l][i] if l < len(self.neighbors) else []
                adj[l, i, :len(nb)] = nb[:deg]
        entry = self.entry
        if self.max_level >= n_levels:  # cap: reroute entry to a top-capped node
            lvl = n_levels - 1
            # entry stays valid — it exists at every layer below its level
        return PaddedGraph(
            vectors=self._matrix().astype(np.float32).copy(),
            adjacency=adj,
            entry=entry,
            n_levels=n_levels,
            node_level=np.minimum(np.asarray(self.levels, np.int32),
                                  n_levels - 1),
        )


def bulk_l0_graph(vectors: np.ndarray, m0: int, *, heuristic: bool = True,
                  slack: int = 2) -> np.ndarray:
    """Fast offline L0 graph build for one (small) partition.

    Exact kNN graph via one matmul (partitions are ~1-10k vectors), then
    the HNSW neighbor-selection heuristic per node, then reverse-edge
    augmentation capped at m0.  This is the standard bulk/offline build
    (paper builds sub-HNSWs offline too) — same search semantics as
    incrementally-built HNSW L0, ~100x faster on the host, and the
    diversified neighborhood makes greedy routing at least as good.

    Returns (n, m0) int32 adjacency, -1 padded.
    """
    v = np.asarray(vectors, np.float32)
    n = v.shape[0]
    if n <= 1:
        return np.full((n, m0), -1, np.int32)
    k = min(m0 * slack + 1, n)
    x2 = np.einsum("nd,nd->n", v, v)
    adj = np.full((n, m0), -1, np.int32)
    chunk = max(1, int(2**26 / max(n, 1)))
    for s in range(0, n, chunk):
        d = x2[None, :] - 2.0 * v[s:s + chunk] @ v.T + x2[s:s + chunk, None]
        for i in range(d.shape[0]):
            d[i, s + i] = np.inf  # no self edge
        idx = np.argpartition(d, k - 1, axis=1)[:, :k]
        dd = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(dd, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        dd = np.take_along_axis(dd, order, axis=1)
        for i in range(idx.shape[0]):
            node = s + i
            if not heuristic:
                adj[node, :min(m0, k)] = idx[i, :m0]
                continue
            kept: list[int] = []
            for dq, c in zip(dd[i], idx[i]):
                if len(kept) >= m0:
                    break
                dc = dq
                ok = True
                for kk in kept:
                    dk = float(np.sum(np.square(v[c] - v[kk])))
                    if dk < dc:
                        ok = False
                        break
                if ok:
                    kept.append(int(c))
            # backfill with nearest pruned (keepPruned)
            for c in idx[i]:
                if len(kept) >= m0:
                    break
                if int(c) not in kept:
                    kept.append(int(c))
            adj[node, :len(kept)] = kept
    # reverse-edge augmentation: ensure in-degree (greedy reachability)
    deg = (adj >= 0).sum(1)
    for node in range(n):
        for c in adj[node]:
            if c < 0:
                break
            if deg[c] < m0 and node not in adj[c, :deg[c]]:
                adj[c, deg[c]] = node
                deg[c] += 1
    return adj


def brute_force_knn(data: np.ndarray, queries: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k ground truth: (dists (Q,k), ids (Q,k)).  Chunked so the
    (Q, N) matrix never exceeds ~256 MB."""
    data = np.asarray(data, np.float32)
    queries = np.asarray(queries, np.float32)
    qn = queries.shape[0]
    ids = np.empty((qn, k), np.int64)
    dists = np.empty((qn, k), np.float32)
    x2 = np.einsum("nd,nd->n", data, data)
    chunk = max(1, int(2**28 / max(data.shape[0], 1) / 4))
    for s in range(0, qn, chunk):
        qc = queries[s:s + chunk]
        d = x2[None, :] - 2.0 * qc @ data.T + np.einsum("qd,qd->q", qc, qc)[:, None]
        idx = np.argpartition(d, min(k, d.shape[1] - 1), axis=1)[:, :k]
        dd = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(dd, axis=1)
        ids[s:s + chunk] = np.take_along_axis(idx, order, axis=1)
        dists[s:s + chunk] = np.take_along_axis(dd, order, axis=1)
    return dists, ids


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean |pred ∩ true| / k."""
    hits = 0
    k = true_ids.shape[1]
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(int(x) for x in p[:k]) & set(int(x) for x in t))
    return hits / (true_ids.shape[0] * k)

"""The plain reference of a k-nearest-neighbour search under squared L2.

Plain PyTorch on the benchmark's own data and queries.  It imports nothing
of the program and takes nothing the program built (no region, meta index
or flat view): it reads only the vectors the benchmark made, and the
program's answers where it judges them.

* ``exact_topk``: the exact k nearest rows of each query.  Candidates come
  from a float32 product (TF32 off) in blocks of queries; the best
  ``k + CANDIDATE_PAD`` of them are ranked again by their float64 distance
  taken directly (sum of squared differences), so rounding in the product
  can only reorder rows whose distances agree to ~1e-6 of the norms.
* ``exact_dists``: the float64 squared distance of given (query, row)
  pairs, taken directly: the yardstick for the distances a search returns.
* ``bf16_topk``: the same search computed one precision below float32, the
  control: bfloat16 inputs, a bfloat16 product and bfloat16 norms.
"""
from __future__ import annotations

import numpy as np
import torch

CANDIDATE_PAD = 22
QUERY_BLOCK = 1024
PAIR_BLOCK = 1 << 16


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_dists(data: torch.Tensor, queries: torch.Tensor,
                qidx: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 between ``queries[qidx[i]]`` and ``data[ids[i,
    j]]``; ``nan`` where an id is out of range.  qidx (R,), ids (R, k)."""
    n = data.shape[0]
    out = torch.empty(ids.shape, dtype=torch.float64, device=ids.device)
    flat_q = qidx[:, None].expand_as(ids).reshape(-1)
    flat_i = ids.reshape(-1)
    flat_o = out.view(-1)
    for s in range(0, flat_i.numel(), PAIR_BLOCK):
        i = flat_i[s:s + PAIR_BLOCK]
        ok = (i >= 0) & (i < n)
        x = data[i.clamp(0, n - 1)].double()
        q = queries[flat_q[s:s + PAIR_BLOCK]].double()
        d = (x - q).square().sum(-1)
        flat_o[s:s + PAIR_BLOCK] = torch.where(ok, d, torch.nan)
    return out


def exact_topk(data: torch.Tensor, queries: torch.Tensor, k: int):
    """(float64 distances (Q, k), int64 ids (Q, k)), nearest first."""
    _no_tf32()
    n = data.shape[0]
    c = min(k + CANDIDATE_PAD, n)
    x2 = data.square().sum(-1)
    ds, ids = [], []
    for s in range(0, queries.shape[0], QUERY_BLOCK):
        q = queries[s:s + QUERY_BLOCK]
        d = x2[None, :] - 2.0 * (q @ data.T)
        cand = torch.topk(d, c, dim=1, largest=False).indices
        qi = torch.arange(s, s + q.shape[0], device=q.device)
        exact = exact_dists(data, queries, qi, cand)
        order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
        ds.append(exact.gather(1, order))
        ids.append(cand.gather(1, order))
    return torch.cat(ds), torch.cat(ids)


def bf16_topk(data: torch.Tensor, queries: torch.Tensor, k: int):
    """The control: the search in bfloat16.  Returns (distances (Q, k) as
    float32, ids (Q, k) int64)."""
    xb = data.bfloat16()
    x2 = xb.square().sum(-1)
    ds, ids = [], []
    for s in range(0, queries.shape[0], QUERY_BLOCK):
        qb = queries[s:s + QUERY_BLOCK].bfloat16()
        d = x2[None, :] - 2.0 * (qb @ xb.T) + qb.square().sum(-1)[:, None]
        top = torch.topk(d.float(), k, dim=1, largest=False)
        ds.append(top.values)
        ids.append(top.indices)
    return torch.cat(ds), torch.cat(ids)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array the benchmark made, copied to ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device)

"""Public wrapper for the fused f32 distance + top-k.

``distance_topk`` runs the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/distance_topk.cu``) for tensors on the
card; there is no fallback from one to the other.  Either way the result
follows the reference wrapper's contract
(``repro/kernels/distance_topk/ops.py``): inputs of any float type are
cast to f32 first, ``n_valid`` defaults to N, and the result is ascending
``(B, k)`` distances and int32 ids with inf/-1 where fewer than ``k`` rows
are valid.  ``use_ref=True`` returns the plain version's raw result, as
the reference does.  ``launches`` counts kernel launches.

Every k runs on the card, by the route ``quant_topk`` picks for it: one
launch of the tiled top-k for ``k <= K_MAX``, else the large-k route (the
product writing every distance, ``csrc/f32_distances.cu``, then the
per-query select, ``quant_topk/csrc/topk_select.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk.ref import distance_topk_ref
from repro_torch.kernels.quant_topk.ops import (K_MAX, arrivals, buffers,
                                                copy_width, large_k,
                                                launch_shape, to_contract)
from repro_torch.obs.trace import TRACER

launches = 0


def _check(queries, database, k: int):
    if queries.dim() != 2 or database.dim() != 2:
        raise ValueError("queries and database must be 2-D")
    if database.shape[1] != queries.shape[1]:
        raise ValueError(f"dim {queries.shape[1]} != database "
                         f"{tuple(database.shape)}")
    if not (queries.is_floating_point() and database.is_floating_point()):
        raise ValueError("queries and database must be floating point")
    if queries.device != database.device:
        raise ValueError("queries and database on different devices")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _plain(q, x, k: int, n_valid: int):
    """The plain version with the kernel's contract (k may exceed N)."""
    d, i = distance_topk_ref(q, x, min(k, x.shape[0]), n_valid)
    return to_contract(d, i, k)


def _launch(q, x, k: int, n_valid: int, bufs, tile: int, S: int) -> None:
    """One launch on f32 inputs into preallocated ``buffers`` (no checks,
    not counted)."""
    B, D = q.shape
    part_d, part_i, out_d, out_i = bufs
    err = _build.library().distance_topk_launch(
        q.data_ptr(), x.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
        arrivals(q.device, -(-B // tile)).data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), B, D, n_valid, k, S, tile, copy_width(4 * D, q, x),
        _build.stream_handle(q.device))
    _build.check(err, "distance_topk")


def _cuda(q, x, k: int, n_valid: int):
    global launches
    B = q.shape[0]
    if not B:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    if k > K_MAX:
        def distances(qb, dist, S):
            err = _build.library().f32_distances_launch(
                qb.data_ptr(), x.data_ptr(), dist.data_ptr(), dist.shape[1],
                qb.shape[0], qb.shape[1], n_valid, S,
                copy_width(4 * qb.shape[1], qb, x),
                _build.stream_handle(qb.device))
            _build.check(err, "f32_distances")
        d, i, n = large_k(q, k, n_valid, False, distances)
        launches += n
        return d, i
    tile, S = launch_shape(B, n_valid, k, quant=False)
    bufs = buffers(B, k, S, q.device)
    _launch(q, x, k, n_valid, bufs, tile, S)
    launches += 1
    return bufs[2], bufs[3]


def distance_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
                  n_valid=None, *, use_ref: bool = False):
    """Top-k nearest database rows per query (squared L2, ascending).

    queries (B, D), database (N, D), any float type (computed in f32)
    -> (dists (B, k) f32, ids (B, k) int32).  ``n_valid`` masks rows at or
    past it (defaults to N)."""
    _check(queries, database, k)
    N = database.shape[0]
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    if use_ref:
        return distance_topk_ref(queries, database, k, nv)
    if queries.device.type == "cpu":
        impl, fn = "ref", _plain
    elif queries.device.type == "cuda":
        impl, fn = "cuda", _cuda
    else:
        raise ValueError(f"distance_topk: unsupported device "
                         f"{queries.device}")
    q = queries.to(torch.float32).contiguous()
    x = database.to(torch.float32).contiguous()
    if not TRACER.enabled:
        return fn(q, x, k, nv)
    with TRACER.device_span("kernel.distance_topk", q.device, tier="kernel",
                            impl=impl, B=int(q.shape[0]), N=int(N),
                            D=int(q.shape[1]), k=int(k)):
        return fn(q, x, k, nv)

"""Public wrapper for the sub-HNSW beam walk.

``beam_walk`` runs the whole layer-0 beam walk of every lane of a batch,
each lane over its own graph: the plain version (``ref.py``, the host
loop of ``core/search.py batched_beam_search``) for tensors on the CPU,
and one launch of the CUDA kernel (``csrc/beam_walk.cu``) for tensors on
the card, from every lane's entry to its stop rule with no host sync;
there is no fallback from one to the other.  ``launches`` counts kernel
launches.

The plain loop counts its own steps.  On the card, with the tracer on, a
launch counts one ``walk_launches``, and its lanes' longest walk, which is
the plain loop's iterations, is counted as ``walk_steps`` without a wait:
the count is copied to pinned host memory behind the kernel and added by
``TRACER.settle()``, which ``ComputeClient.search`` calls once its final
readback has waited for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.beam_walk.ref import beam_walk_ref
from repro_torch.obs.trace import TRACER

launches = 0


def _check(vectors, adjacency, queries, entry, ef: int) -> None:
    if vectors.dim() != 3 or adjacency.dim() != 3 or queries.dim() != 2:
        raise ValueError(f"vectors (B, n, D), adjacency (B, n, deg) and "
                         f"queries (B, D), got {tuple(vectors.shape)}, "
                         f"{tuple(adjacency.shape)}, {tuple(queries.shape)}")
    B, n, D = vectors.shape
    if (adjacency.shape[:2] != (B, n) or queries.shape != (B, D)
            or entry.shape != (B,)):
        raise ValueError(f"shapes disagree: vectors {tuple(vectors.shape)}, "
                         f"adjacency {tuple(adjacency.shape)}, queries "
                         f"{tuple(queries.shape)}, entry "
                         f"{tuple(entry.shape)}")
    if len({vectors.device, adjacency.device, queries.device,
            entry.device}) != 1:
        raise ValueError("vectors, adjacency, queries and entry on "
                         "different devices")
    if ef < 1:
        raise ValueError(f"ef must be >= 1, got {ef}")


def launch(vectors, adjacency, queries, entry, *, ef: int,
           max_iters: Optional[int] = None):
    """One launch on CUDA tensors (checked by ``beam_walk``) -> (dists
    (B, ef) f32, ids (B, ef) int64, steps (B,) int32: each lane's beam
    steps).  Raises on a shape the kernel does not take: its limits on
    deg, ef and shared memory are checked in ``csrc/beam_walk.cu`` alone."""
    global launches
    B, n, D = vectors.shape
    deg = adjacency.shape[2]
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        raise ValueError("beam_walk: vectors and queries must be float32 "
                         "on the card")
    dev = queries.device
    if vectors.stride(2) != 1:
        vectors = vectors.contiguous()
    adjacency = adjacency.to(torch.int32)
    if adjacency.stride(2) != 1:
        adjacency = adjacency.contiguous()
    if queries.stride(1) != 1:
        queries = queries.contiguous()
    entry = entry.to(torch.long).contiguous()
    out_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, ef), dtype=torch.long, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        err = _build.library().beam_walk_launch(
            vectors.data_ptr(), vectors.stride(0), vectors.stride(1),
            adjacency.data_ptr(), adjacency.stride(0), adjacency.stride(1),
            queries.data_ptr(), queries.stride(0), entry.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), steps.data_ptr(), B, n, D,
            deg, ef, max_iters or (2 * ef + 8), _build.stream_handle(dev))
        _build.check(err, f"beam_walk (n {n}, D {D}, deg {deg}, ef {ef})")
        launches += 1
    return out_d, out_i, steps


def beam_walk(vectors, adjacency, queries, entry, *, ef: int,
              max_iters: Optional[int] = None):
    """Beam-search each lane's graph from its entry: vectors (B, n, D),
    adjacency (B, n, deg) local ids with -1 padding (an id >= n is read as
    n - 1 and kept raw in the result), queries (B, D), entry (B,) in
    [0, n) -> (dists (B, ef) f32, ids (B, ef) int64), ascending, inf / -1
    padded.  ``max_iters`` defaults to 2 * ef + 8 beam steps."""
    _check(vectors, adjacency, queries, entry, ef)
    if queries.device.type == "cpu":
        return beam_walk_ref(vectors, adjacency, queries, entry, ef=ef,
                             max_iters=max_iters)
    if queries.device.type != "cuda":
        raise ValueError(f"beam_walk: unsupported device {queries.device}")
    d, i, steps = launch(vectors, adjacency, queries, entry, ef=ef,
                         max_iters=max_iters)
    if TRACER.enabled and steps.shape[0]:
        TRACER.count("walk_launches")
        longest = torch.empty((), dtype=torch.int32, pin_memory=True)
        longest.copy_(steps.max(), non_blocking=True)
        TRACER.count_later("walk_steps", longest)
    return d, i

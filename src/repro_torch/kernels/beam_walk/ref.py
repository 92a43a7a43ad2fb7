"""Plain torch version of the sub-HNSW beam walk: ``batched_beam_search``
on the per-lane path (one layer, every lane its own graph)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import search as S


def beam_walk_ref(vectors: torch.Tensor, adjacency: torch.Tensor,
                  queries: torch.Tensor, entry, *, ef: int,
                  max_iters: Optional[int] = None):
    """vectors (B, n, D); adjacency (B, n, deg); queries (B, D); entry
    (B,) -> (dists (B, ef) f32, ids (B, ef) int64), ascending, inf / -1
    padded."""
    return S.batched_beam_search(vectors, adjacency[:, None], queries, entry,
                                 ef=ef, n_levels=1, max_iters=max_iters)

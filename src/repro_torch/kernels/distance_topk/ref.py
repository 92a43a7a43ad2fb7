"""Plain torch version of the fused f32 distance + top-k."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_topk.ref import topk_ascending


def distance_topk_ref(queries: torch.Tensor, database: torch.Tensor, k: int,
                      n_valid=None):
    """Exact squared-L2 top-k.

    queries (B, D); database (N, D) -> (dists (B, k), ids (B, k) int32),
    ascending, ties to the lower id.  ``n_valid`` masks padded database
    rows to +inf.  On the card the product runs in full f32 (TF32 off).
    """
    if queries.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    q = queries.to(torch.float32)
    x = database.to(torch.float32)
    d = ((q * q).sum(-1)[:, None] - 2.0 * (q @ x.T)
         + (x * x).sum(-1)[None, :])
    if n_valid is not None:
        rows = torch.arange(x.shape[0], device=d.device)[None, :]
        d = torch.where(rows < int(n_valid), d, torch.inf)
    d, i = topk_ascending(d, k)
    return d, i.to(torch.int32)

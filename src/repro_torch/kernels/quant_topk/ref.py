"""Plain torch version of the fused int8 dequant + distance + top-k."""
from __future__ import annotations

import torch


def dequantize_ref(codes: torch.Tensor, scales: torch.Tensor, group: int):
    """codes (N, D) int8, scales (N, D // group) f32 -> (N, D) f32."""
    n, d = codes.shape
    x = codes.to(torch.float32).reshape(n, d // group, group)
    return (x * scales[:, :, None]).reshape(n, d)


def topk_ascending(d: torch.Tensor, k: int):
    """The k smallest entries of each row, ascending, ties to the lower
    index (``lax.top_k(-d, k)``'s order; ``torch.topk`` promises none)."""
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return torch.gather(d, -1, order), order


def ids_agree_up_to_ties(ids, ref_ids, ref_d, rtol: float = 1e-5):
    """Hold top-k ids against a reference list of at least k + 1 entries.

    ids (B, k); ref_ids / ref_d (B, >= k + 1) ascending, numpy.  An id may
    differ from the reference's at the same rank only if the reference
    lists it at a rank whose distance ties with this rank's within
    ``rtol`` relative (so the k-th place may go to the (k+1)-th row when
    the two tie).  Returns (ok, number of differing positions)."""
    import numpy as np
    ids = np.asarray(ids)
    ref_ids = np.asarray(ref_ids)
    d = np.asarray(ref_d, np.float64)
    diff = ids != ref_ids[:, :ids.shape[1]]
    for b, j in zip(*np.nonzero(diff)):
        at = np.nonzero(ref_ids[b] == ids[b, j])[0]
        if not len(at):
            return False, int(diff.sum())
        with np.errstate(invalid="ignore"):
            tol = rtol * np.maximum(np.abs(d[b, at]), abs(d[b, j]))
            if not (np.abs(d[b, at] - d[b, j]) <= tol).any():
                return False, int(diff.sum())
    return True, int(diff.sum())


def quant_topk_ref(queries: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, k: int, group: int, n_valid=None):
    """Exact squared-L2 top-k over the dequantized database.

    queries (B, D) f32; codes (N, D) int8; scales (N, D // group) f32
    -> (dists (B, k), ids (B, k)), ascending.  ``n_valid`` masks padded
    database rows.  On the card the product runs in full f32 (TF32 off).
    """
    if queries.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    q = queries.to(torch.float32)
    x = dequantize_ref(codes, scales, group)
    d = ((q * q).sum(-1)[:, None] - 2.0 * (q @ x.T)
         + (x * x).sum(-1)[None, :])
    if n_valid is not None:
        rows = torch.arange(x.shape[0], device=d.device)[None, :]
        d = torch.where(rows < int(n_valid), d, torch.inf)
    d, i = topk_ascending(d, k)
    return d, i.to(torch.int32)

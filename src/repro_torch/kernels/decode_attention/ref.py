"""Plain torch version of GQA flash-decode attention."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, pos):
    """One-token GQA attention against a KV cache.

    q (B, H, hd); k/v (B, S, K, hd); pos (B,) = number of valid cache
    entries per sequence (attend to cache[:pos]).  H = K * G.
    Returns (B, H, hd) f32.  A row with ``pos = 0`` has every score
    masked, so its softmax is uniform and the result is the mean of v
    (the reference's oracle does the same; its Pallas kernel returns 0).
    On the card the products run in full f32 (TF32 off).
    """
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float()) * (hd ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < pos[:, None]  # (B, S)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return out.reshape(B, H, hd)

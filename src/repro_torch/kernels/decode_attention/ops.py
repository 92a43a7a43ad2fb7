"""Public wrapper for GQA flash-decode attention.

``decode_attention`` runs the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/decode_attention.cu``) for tensors on
the card; there is no fallback from one to the other.  Either way the
result follows the reference wrapper's contract
(``repro/kernels/decode_attention/ops.py``): ``(B, H, hd)`` in q's
dtype.  ``launches`` counts kernel launches (one per call:
both passes).

One behaviour differs between the two, as it does in the reference: at
``pos = 0`` the kernel returns zeros (the Pallas kernel skips every
block) and the plain version the mean of v (the oracle's softmax over an
all-masked row).  The decode path never passes 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.obs.trace import TRACER

launches = 0
HD_MAX = 256         # longest head the kernel takes (a multiple of 8)
G_MAX = 16           # most query heads per kv head
_TILE = 64           # keys per tile of csrc/decode_attention.cu
_TARGET_CTAS = 4 * 132   # about four waves on the H100's 132 SMs


def splits(B: int, K: int, S: int) -> tuple[int, int]:
    """(n_split, split_len): how pass 1 cuts each cache of S entries so
    that the B * K (sequence, kv head) pairs make about ``_TARGET_CTAS``
    CTAs, never a range shorter than one tile."""
    tiles = -(-S // _TILE)
    n = max(1, min(tiles, -(-_TARGET_CTAS // max(B * K, 1))))
    split_len = -(-tiles // n) * _TILE
    return -(-S // split_len), split_len


def _check(q, k, v, pos):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, H, hd), k/v (B, S, K, hd): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, k, v and pos on different devices")


def _launch(q, k, v, pos, part_ml, part_acc, out, n_split: int,
            split_len: int) -> None:
    """Launch both passes into preallocated buffers (no checks, not
    counted)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    lib = _build.library()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, S, K,
        H // K, hd, n_split, split_len, int(q.dtype == torch.bfloat16),
        _build.stream_handle(q.device))
    _build.check(err, "decode_attention")


def buffers(q, k) -> tuple:
    """(part_ml, part_acc, out, n_split, split_len) for one launch."""
    B, H, hd = q.shape
    n_split, split_len = splits(B, k.shape[2], k.shape[1])
    dev = q.device
    return (torch.empty((B * H, n_split, 2), dtype=torch.float32, device=dev),
            torch.empty((B * H, n_split, hd), dtype=torch.float32,
                        device=dev),
            torch.empty_like(q), n_split, split_len)


def _cuda(q, k, v, pos):
    global launches
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attention kernel takes q, k and v all f32 "
                         f"or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 8 or hd > HD_MAX or H // K > G_MAX or S < 1:
        raise ValueError(f"decode_attention kernel takes hd a multiple of 8 "
                         f"up to {HD_MAX}, at most {G_MAX} query heads per "
                         f"kv head and S >= 1; got hd={hd}, G={H // K}, "
                         f"S={S}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention kernel reads 16-byte words: q, k "
                         "and v must start on a 16-byte boundary")
    pos = pos.to(torch.int32).contiguous()
    part_ml, part_acc, out, n_split, split_len = buffers(q, k)
    if B:
        _launch(q, k, v, pos, part_ml, part_acc, out, n_split, split_len)
        launches += 1
    return out


def _plain(q, k, v, pos):
    """The plain version with the kernel's contract (q's dtype)."""
    return decode_attention_ref(q, k, v, pos).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor):
    """One-token GQA attention against a KV cache.

    q (B, H, hd); k/v (B, S, K, hd); pos (B,) = number of valid cache
    entries per sequence -> (B, H, hd) in q's dtype."""
    _check(q, k, v, pos)
    if q.device.type == "cpu":
        impl, fn = "ref", _plain
    elif q.device.type == "cuda":
        impl, fn = "cuda", _cuda
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not TRACER.enabled:
        return fn(q, k, v, pos)
    B, H, hd = q.shape
    with TRACER.span("kernel.decode_attention", tier="kernel", impl=impl,
                     B=int(B), H=int(H), K=int(k.shape[2]), S=int(k.shape[1]),
                     hd=int(hd)):
        out = fn(q, k, v, pos)
        if impl == "cuda":
            torch.cuda.synchronize(q.device)
        return out

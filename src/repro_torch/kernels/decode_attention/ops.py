"""Public wrapper for GQA flash-decode attention.

``decode_attention`` runs the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/decode_attention.cu``) for tensors on
the card; there is no fallback from one to the other.  Either way the
result follows the reference wrapper's contract
(``repro/kernels/decode_attention/ops.py``): ``(B, H, hd)`` in q's
dtype.  ``launches`` counts kernel launches: one per call, the combine
of the splits included; ``partial_launches`` those of them in the
partial mode.

One behaviour differs between the two, as it does in the reference: at
``pos = 0`` the kernel returns zeros (the Pallas kernel skips every
block) and the plain version the mean of v (the oracle's softmax over an
all-masked row).  The decode path never passes 0.

``partial=True`` is for a cache sharded by sequence over ranks: each
rank attends its shard (``pos`` its count of valid entries there, 0
allowed) and gets the softmax over those keys alone in f32 and its
log-sum-exp, -inf with a zero row where it has none (both versions
alike), which ``layers.merge_parts`` merges over the ranks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.obs.trace import TRACER

launches = 0
partial_launches = 0
HD_MAX = 256         # longest head the kernel takes (a multiple of 8)
G_MAX = 16           # most query heads per kv head
_TILE = 64           # split ranges are whole tiles of this many keys
WARPS = 8            # warps of a CTA
# warps in flight: one 8-warp CTA on each of the H100's 132 SMs (about 170
# registers a thread leave room for one), as (sequence, kv head) pairs x
# warps per head x splits; the cuts python3 chip_smoke.py --sweep times
_TARGET_WARPS = WARPS * 132
# (sequence, head group) arrival counters of the split combine, per
# (device, stream): zeroed once, left at 0 by every launch
_arrivals: dict = {}


def _per_pair(B: int, K: int) -> int:
    """Warps each (sequence, kv head) pair gets of ``_TARGET_WARPS``."""
    return max(1, _TARGET_WARPS // max(B * K, 1))


def warps_per_head(B: int, K: int) -> int:
    """How many of a CTA's warps share one kv head's range (a power of two
    up to ``WARPS``): all of them when the pairs are few, one when the
    pairs alone fill the card."""
    wph = 1
    while wph * 2 <= min(_per_pair(B, K), WARPS):
        wph *= 2
    return wph


def splits(B: int, K: int, S: int) -> tuple[int, int]:
    """(n_split, split_len): how the kernel cuts each cache of S entries so
    that pairs x warps per head x splits make about ``_TARGET_WARPS``
    warps, never a range shorter than one tile."""
    tiles = -(-S // _TILE)
    n = max(1, min(tiles, _per_pair(B, K) // warps_per_head(B, K)))
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


def arrivals(device, n: int) -> torch.Tensor:
    """The arrival counters of PyTorch's current stream on ``device``, at
    least ``n`` of them, all 0 between launches."""
    key = (device, _build.stream_handle(device))
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrivals[key] = buf
    return buf


def _launch(q, k, v, pos, part_ml, part_acc, out, n_split: int,
            split_len: int, warps: int = WARPS, wph: int | None = None,
            lse=None) -> None:
    """Launch the kernel into preallocated buffers (no checks, not
    counted).  ``wph`` defaults to ``warps_per_head``; both are cut to
    what the CTA and the kv heads can use.  ``lse`` (B, H) f32: the
    partial mode (``out`` then f32)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    wph = min(wph or warps_per_head(B, K), warps)
    while warps % wph:
        wph //= 2
    warps = min(warps, wph * K)
    lib = _build.library()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        arrivals(q.device, B * K).data_ptr(), out.data_ptr(), B, S, K,
        H // K, hd, n_split, split_len, warps, wph,
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device),
        None if lse is None else lse.data_ptr())
    _build.check(err, "decode_attention")


def buffers(q, k, n_split: int | None = None,
            split_len: int | None = None) -> tuple:
    """(part_ml, part_acc, out, n_split, split_len) for one launch, cut
    as ``splits`` cuts unless both are given."""
    B, H, hd = q.shape
    K = k.shape[2]
    if n_split is None or split_len is None:
        n_split, split_len = splits(B, K, k.shape[1])
    dev, G = q.device, H // K
    return (torch.empty((B * K, n_split, G, 2), dtype=torch.float32,
                        device=dev),
            torch.empty((B * K, n_split, G, hd), dtype=torch.float32,
                        device=dev),
            torch.empty_like(q), n_split, split_len)


def _cuda(q, k, v, pos, partial=False):
    global launches, partial_launches
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
    lse = None
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B:
        _launch(q, k, v, pos, part_ml, part_acc, out, n_split, split_len,
                lse=lse)
        launches += 1
        partial_launches += int(partial)
    return (out, lse) if partial else out


def _plain(q, k, v, pos, partial=False):
    """The plain version with the kernel's contract (q's dtype, or the
    partial mode's f32 pair)."""
    if partial:
        return decode_attention_ref(q, k, v, pos, partial=True)
    return decode_attention_ref(q, k, v, pos).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, partial: bool = False):
    """One-token GQA attention against a KV cache.

    q (B, H, hd); k/v (B, S, K, hd); pos (B,) = number of valid cache
    entries per sequence -> (B, H, hd) in q's dtype; with ``partial``
    (out (B, H, hd) f32, lse (B, H) f32)."""
    _check(q, k, v, pos)
    if q.device.type == "cpu":
        impl, fn = "ref", _plain
    elif q.device.type == "cuda":
        impl, fn = "cuda", _cuda
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not TRACER.enabled:
        return fn(q, k, v, pos, partial)
    B, H, hd = q.shape
    with TRACER.device_span("kernel.decode_attention", q.device,
                            tier="kernel", impl=impl, B=int(B), H=int(H),
                            K=int(k.shape[2]), S=int(k.shape[1]),
                            hd=int(hd)):
        return fn(q, k, v, pos, partial)

"""Public wrapper for the fused int8 dequant + distance + top-k.

``quant_topk`` runs the plain version for tensors on the CPU and launches
the CUDA kernel (``csrc/quant_topk.cu``) for tensors on the card; there
is no fallback from one to the other.  Either way the result follows the
reference wrapper's contract (``repro/kernels/quant_topk/ops.py``):
ascending ``(B, k)`` distances and int32 ids, with inf/-1 where fewer
than ``k`` rows are valid.  ``use_ref=True`` returns the plain version's
raw result, as the reference does.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_topk.ref import quant_topk_ref
from repro_torch.obs.trace import TRACER

launches = 0
K_MAX = 128          # longest top-k list the kernel keeps per query
_BQ, _BN = 64, 64    # query tile and database tile of csrc/quant_topk.cu
_TARGET_CTAS = 4 * 132   # about four waves on the H100's 132 SMs


def n_chunks(B: int, n_valid: int) -> int:
    """How many database chunks pass 1 splits the valid rows into: enough
    CTAs for ~4 waves, never a chunk shorter than one tile."""
    q_tiles = -(-B // _BQ)
    n_tiles = max(-(-n_valid // _BN), 1)
    return max(1, min(n_tiles, -(-_TARGET_CTAS // q_tiles)))


def _check(queries, codes, scales, k: int, group: int):
    if queries.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError("queries, codes and scales must be 2-D")
    B, D = queries.shape
    N = codes.shape[0]
    if codes.shape[1] != D or D % group:
        raise ValueError(f"dim {D} / codes {tuple(codes.shape)} / "
                         f"group {group} mismatch")
    if tuple(scales.shape) != (N, D // group):
        raise ValueError(f"scales {tuple(scales.shape)} != {(N, D // group)}")
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    if not (queries.device == codes.device == scales.device):
        raise ValueError("queries, codes and scales on different devices")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def to_contract(d, i, k: int):
    """A plain top-list in the kernels' contract: inf/-1 at every entry
    that is not finite, padded with inf/-1 to ``k`` columns."""
    bad = ~torch.isfinite(d)
    d = torch.where(bad, torch.inf, d)
    i = torch.where(bad, -1, i)
    pad = k - d.shape[1]
    if pad > 0:
        d = torch.cat([d, d.new_full((d.shape[0], pad), torch.inf)], 1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
    return d, i


def _plain(queries, codes, scales, k: int, group: int, n_valid: int):
    """The plain version with the kernel's contract (k may exceed N)."""
    kk = min(k, codes.shape[0])
    return to_contract(*quant_topk_ref(queries, codes, scales, kk, group,
                                       n_valid), k)


def _launch(queries, codes, scales, k: int, group: int, n_valid: int,
            part_d, part_i, out_d, out_i, S: int) -> None:
    """Launch both passes into preallocated buffers (no checks, not
    counted)."""
    B, D = queries.shape
    lib = _build.library()
    err = lib.quant_topk_launch(
        queries.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), B, D, group, n_valid, k, S,
        _build.stream_handle(queries.device))
    _build.check(err, "quant_topk")


def _cuda(queries, codes, scales, k: int, group: int, n_valid: int):
    global launches
    if k > K_MAX:
        raise ValueError(f"quant_topk kernel keeps at most {K_MAX} per "
                         f"query, asked for {k}")
    q = queries.to(torch.float32).contiguous()
    c = codes.contiguous()
    s = scales.to(torch.float32).contiguous()
    B = q.shape[0]
    S = n_chunks(B, n_valid)
    dev = q.device
    part_d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B:
        _launch(q, c, s, k, group, n_valid, part_d, part_i, out_d, out_i, S)
        launches += 1
    return out_d, out_i


def quant_topk(queries: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor, k: int, group: int, n_valid=None, *,
               use_ref: bool = False):
    """Top-k nearest database rows per query over an int8-quantized
    database (squared L2 on the dequantized values, ascending).

    queries (B, D) f32, codes (N, D) int8, scales (N, D // group) f32
    -> (dists (B, k) f32, ids (B, k) int32).  ``n_valid`` masks rows at
    or past it (defaults to N)."""
    _check(queries, codes, scales, k, group)
    N = codes.shape[0]
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    if use_ref:
        return quant_topk_ref(queries, codes, scales, k, group, nv)
    if queries.device.type == "cpu":
        impl, fn = "ref", _plain
    elif queries.device.type == "cuda":
        impl, fn = "cuda", _cuda
    else:
        raise ValueError(f"quant_topk: unsupported device {queries.device}")
    if not TRACER.enabled:
        return fn(queries, codes, scales, k, group, nv)
    with TRACER.span("kernel.quant_topk", tier="kernel", impl=impl,
                     B=int(queries.shape[0]), N=int(N),
                     D=int(codes.shape[1]), k=int(k)):
        out = fn(queries, codes, scales, k, group, nv)
        if impl == "cuda":
            torch.cuda.synchronize(queries.device)
        return out

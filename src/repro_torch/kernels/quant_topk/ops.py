"""Public wrapper for the fused int8 dequant + distance + top-k.

``quant_topk`` runs the plain version for tensors on the CPU and launches
the CUDA kernel (``csrc/quant_topk.cu``) for tensors on the card; there
is no fallback from one to the other.  Either way the result follows the
reference wrapper's contract (``repro/kernels/quant_topk/ops.py``):
ascending ``(B, k)`` distances and int32 ids, with inf/-1 where fewer
than ``k`` rows are valid.  ``use_ref=True`` returns the plain version's
raw result, as the reference does.  ``launches`` counts kernel launches.

Every k, group and D the reference serves runs on the card; the wrapper
picks the route by k, never after a failure:

* ``k <= K_MAX`` (128): one launch of the tiled top-k
  (``csrc/quant_topk.cu`` over ``kernels/csrc/topk_tile.cuh``);
* larger k: the large-k route, two launches per block of queries — the
  same product writing every distance (``csrc/quant_distances.cu``),
  then a per-query radix select (``csrc/topk_select.cu``); the blocks
  keep the distance matrix under ``SELECT_BYTES``.

A group that is not a multiple of 4 takes the kernel's per-code scale
path, and codes whose rows are not a multiple of 4 bytes are zero-padded
to one (a layout step: zero codes against zero query entries add nothing
to a distance).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_topk.ref import quant_topk_ref
from repro_torch.obs.trace import TRACER

launches = 0
K_MAX = 128          # longest top-k list the tiled kernel keeps per query
# the large-k route: distance-matrix bytes per block of queries, and the
# lists topk_select.cu sorts in shared memory (kSortSmem; longer ones in a
# scratch of B x P words)
SELECT_BYTES = 1 << 30
SORT_SMEM = 16384
# csrc/topk_tile.cuh: slices of 64 dimensions (rows padded by 4 floats),
# 32 candidate slots a query, and at each square tile the threads, the
# copy-ring stages and the registers a thread (``-Xptxas -v``, the larger
# of the f32 and int8 instantiations).  A CTA may take 227 KB of shared
# memory, an SM holds 228 KB, 1 KB of it reserved per CTA.
TILES = (128, 64)    # queries x rows per CTA
_SHAPE = {128: dict(threads=512, ring=2, regs=128),
          64: dict(threads=256, ring=3, regs=152)}
_DK, _CAND = 64, 32
SMEM_MAX, SMEM_SM, SMEM_CTA = 232_448, 233_472, 1024
SMS = 132            # the H100's SMs
# the launch-shape cost, in row tiles of the chosen size, set from
# ``python3 chip_smoke.py --sweep``: each chunk's fixed work (its first
# tile sends every row through the candidate buffers, then its list is
# written) and the last CTA's merge, which grows with the chunks
MIN_TILES = 2        # shortest chunk, in row tiles, unless the rows are fewer
CHUNK_TILES = 4.0    # a chunk's fixed work
MERGE_TILES = 0.08   # the final merge, per chunk
# arrival counters of the chunk merge, per (device, stream): zeroed once,
# left at 0 by every launch
_arrivals: dict = {}


def smem_bytes(tile: int, k: int, quant: bool) -> int:
    """Shared memory of one CTA (``topk_tile::smem_bytes``)."""
    R, ld = _SHAPE[tile]["ring"], _DK + 4
    stages = (R * tile * _DK + 4 * (tile * ld + R * tile * (_DK // 4))
              if quant else 4 * R * tile * ld)
    return (4 * (R * tile * ld + 2 * tile) + stages
            + 8 * tile * (k + _CAND) + 4 * (tile + 1))


def ctas_per_sm(tile: int, k: int, quant: bool) -> int:
    """CTAs of ``tile`` one SM holds: by shared memory and by registers
    (0: the tile's shared memory does not fit at this k)."""
    c = _SHAPE[tile]
    smem = smem_bytes(tile, k, quant)
    if smem > SMEM_MAX:
        return 0
    return min(SMEM_SM // (smem + SMEM_CTA),
               65536 // (c["threads"] * c["regs"]))


def chunks(B: int, n_valid: int, tile: int, k: int, quant: bool) -> int:
    """How many chunks a launch at ``tile`` splits the valid rows into: the
    cut with the least cost, whole waves of CTAs times (the tiles of a
    chunk + ``CHUNK_TILES``) + ``MERGE_TILES`` a chunk, chunks of at least
    ``MIN_TILES`` tiles, the fewest chunks among equal cuts.  Every chunk
    holds rows."""
    q_tiles = -(-B // tile)
    n_tiles = max(-(-n_valid // tile), 1)
    wave = SMS * ctas_per_sm(tile, k, quant)
    best = None
    for S in range(1, max(n_tiles // MIN_TILES, 1) + 1):
        per = -(-n_tiles // S)        # as the kernel cuts the rows
        if -(-n_tiles // per) != S:   # a chunk would be empty
            continue
        cost = (-(-(q_tiles * S) // wave) * (per + CHUNK_TILES)
                + MERGE_TILES * S)
        if best is None or cost < best[0]:
            best = (cost, S)
    return best[1]


def launch_shape(B: int, n_valid: int, k: int, quant: bool) -> tuple:
    """(tile, S) of one top-k launch: 128 x 128 tiles when there are enough
    of them to give every SM's CTAs a chunk of ``MIN_TILES`` tiles and
    their shared memory fits, else 64 x 64; then ``chunks``."""
    big = TILES[0]
    cps = ctas_per_sm(big, k, quant)
    n_big = -(-B // big) * max(-(-n_valid // big), 1)
    tile = big if cps and n_big >= SMS * cps * MIN_TILES else TILES[1]
    return tile, chunks(B, n_valid, tile, k, quant)


def copy_width(row_bytes: int, *tensors) -> int:
    """The kernel's copy width: the widest of 16, 8 and 4 bytes that divides
    a row and every tensor's start."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    raise ValueError(f"top-k kernel copies 4-byte words at least: rows of "
                     f"{row_bytes} B do not divide into them")


def arrivals(device, n: int) -> torch.Tensor:
    """The arrival counters of PyTorch's current stream on ``device``, at
    least ``n`` of them, all 0 between launches."""
    key = (device, _build.stream_handle(device))
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrivals[key] = buf
    return buf


def buffers(B: int, k: int, S: int, device) -> tuple:
    """One launch's scratch and output: (part_d, part_i) (B, S, k), the
    chunks' lists, and (out_d, out_i) (B, k)."""
    return (torch.empty((B, S, k), dtype=torch.float32, device=device),
            torch.empty((B, S, k), dtype=torch.int32, device=device),
            torch.empty((B, k), dtype=torch.float32, device=device),
            torch.empty((B, k), dtype=torch.int32, device=device))


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
            bufs, tile: int, S: int) -> None:
    """One launch of the tiled top-k (k <= K_MAX) into preallocated
    ``buffers`` (no checks, not counted).  ``kernel_layout`` gives the
    inputs."""
    B, D = queries.shape
    part_d, part_i, out_d, out_i = bufs
    err = _build.library().quant_topk_launch(
        queries.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(),
        arrivals(queries.device, -(-B // tile)).data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), B, D, group, scales.shape[1], n_valid, k, S, tile,
        copy_width(D, codes), _build.stream_handle(queries.device))
    _build.check(err, "quant_topk")


def kernel_layout(queries, codes, scales):
    """The kernels' inputs: f32 queries starting on 16 bytes, contiguous
    codes and f32 scales.  Rows of D % 4 != 0 codes are zero-padded to a
    multiple of 4 (the queries too): a layout step for the 4-byte copies,
    not a fallback — a zero code against a zero query entry adds nothing
    to a distance, and the kernel gives the padding the row's last
    scale."""
    q = queries.to(torch.float32).contiguous()
    c = codes.contiguous()
    s = scales.to(torch.float32).contiguous()
    pad = -q.shape[1] % 4
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        c = torch.nn.functional.pad(c, (0, pad))
    if q.data_ptr() % 16:
        q = q.clone()
    if c.data_ptr() % 4:
        c = c.clone()
    return q, c, s


def select_blocks(B: int, n_valid: int) -> int:
    """Queries per block of the large-k route: its (block, n_valid) f32
    distance matrix stays under ``SELECT_BYTES``."""
    return max(1, min(B, SELECT_BYTES // (4 * max(n_valid, 1))))


def select_scratch(Bq: int, k: int, n_valid: int, device):
    """topk_select.cu's sort scratch for a block of ``Bq`` queries: None
    when its lists sort in shared memory."""
    P = 1 << max(min(k, n_valid) - 1, 0).bit_length()
    if P <= SORT_SMEM:
        return None
    return torch.empty((Bq, P), dtype=torch.int64, device=device)


def select_launch(dist, n_valid: int, k: int, scratch, out_d, out_i) -> None:
    """One launch of topk_select.cu: the k smallest of each row of
    ``dist`` (B, ld) below column n_valid, into out_d / out_i (no checks,
    not counted)."""
    err = _build.library().topk_select_launch(
        dist.data_ptr(), dist.shape[1], dist.shape[0], n_valid, k,
        0 if scratch is None else scratch.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), _build.stream_handle(dist.device))
    _build.check(err, "topk_select")


def large_k(q, k: int, n_valid: int, quant: bool, distances) -> tuple:
    """The large-k route over the queries ``q`` (B, D), block by block of
    ``select_blocks`` queries: ``distances(q_block, dist, S)`` launches
    the product into ``dist`` (block, n_valid) over S chunks of rows,
    then ``select_launch``.  Returns ((B, k) distances, (B, k) int32 ids,
    kernel launches)."""
    B = q.shape[0]
    out_d = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    Bq = select_blocks(B, n_valid)
    dist = torch.empty((Bq, max(n_valid, 1)), dtype=torch.float32,
                       device=q.device)
    scratch = select_scratch(Bq, k, n_valid, q.device)
    n = 0
    for b0 in range(0, B, Bq):
        b1 = min(B, b0 + Bq)
        if n_valid:
            distances(q[b0:b1], dist, chunks(b1 - b0, n_valid, TILES[0], 0,
                                             quant))
            n += 1
        select_launch(dist[:b1 - b0], n_valid, k, scratch, out_d[b0:b1],
                      out_i[b0:b1])
        n += 1
    return out_d, out_i, n


def _cuda(queries, codes, scales, k: int, group: int, n_valid: int):
    global launches
    q, c, s = kernel_layout(queries, codes, scales)
    B = q.shape[0]
    if not B:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    if k > K_MAX:
        def distances(qb, dist, S):
            err = _build.library().quant_distances_launch(
                qb.data_ptr(), c.data_ptr(), s.data_ptr(), dist.data_ptr(),
                dist.shape[1], qb.shape[0], qb.shape[1], group, s.shape[1],
                n_valid, S, copy_width(qb.shape[1], c),
                _build.stream_handle(qb.device))
            _build.check(err, "quant_distances")
        d, i, n = large_k(q, k, n_valid, True, distances)
        launches += n
        return d, i
    tile, S = launch_shape(B, n_valid, k, quant=True)
    bufs = buffers(B, k, S, q.device)
    _launch(q, c, s, k, group, n_valid, bufs, tile, S)
    launches += 1
    return bufs[2], bufs[3]


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
    with TRACER.device_span("kernel.quant_topk", queries.device,
                            tier="kernel", impl=impl,
                            B=int(queries.shape[0]), N=int(N),
                            D=int(codes.shape[1]), k=int(k)):
        return fn(queries, codes, scales, k, group, nv)

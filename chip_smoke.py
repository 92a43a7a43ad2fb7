#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of d-HNSW once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. kernel build: every ``src/repro_torch/kernels/*/csrc/*.cu`` with
   ``nvcc`` for ``sm_90a``;
3. index build on the host: ``sift_like(n=100_000, n_queries=2000)``,
   256 partitions (the paper's geometry, cut as ``reduced`` says);
4. kernels against their plain torch versions on the card at the shapes
   the paths give them (for the gather, the ids of every launch of
   phases 5, 8 and 9, planned as the engine plans them; for
   ``distance_topk``, the throughput benchmark's B=128 x N=4096 and the
   flat f32 twin of ``quant_topk``'s shape; for ``decode_attention``,
   phase 9's first decode call and a long-context shape), with times
   (CUDA events) beside the bound, the plain version's time and the
   library call's time;
5. exact search (``mode="full"``, b=4, ef=48, doorbell 16, RDMA fabric,
   the CUDA doorbell gather) for ``search_mode`` graph and scan, one batch
   of 2000 at k=10, held against the same engine with the gather off;
6. int8 flat search (``quant_kernel="auto"``: the CUDA ``quant_topk``
   stage 1), held against ``quant_kernel="ref"``;
7. the throughput benchmark (``benchmarks/torch_throughput.py`` at the
   ``full`` preset, on the index of phase 3): QPS vs batch, cache and
   doorbell ablations, and ``distance_topk`` against its plain version;
   its doorbell-16 row must count what phase 5's scan batch counted;
8. int8 search through the per-pair stage 1 (``benchmarks/
   torch_quant.py``'s per-pair cell: ``quant_kernel="off"``,
   ``cache_frac`` 0.25, ``exact_frac`` 0.25, b=6, doorbell 16) in both
   search modes, 2000 queries in 4 batches, with the CUDA gather, held
   against the same engine with the gather off (in turns);
9. RAG serving at full width: ``RagServeEngine`` with ``qwen3-8b`` (36
   layers, d 4096, 32 query heads over 8 kv heads, vocab 151936; weights
   from a seeded generator on the card) over phase 5's exact-scan engine
   with the CUDA gather, whose 100k vectors are the documents' embeddings
   (240 tokens each): two ``serve`` calls of the same 8 prompts of 64
   tokens (prefill at S = 4 * 240 + 64 = 1024 through the flash path, 32
   greedy decode steps, every layer's decode attention through the CUDA
   ``decode_attention``), equal tokens from both; then a third call
   under ``torch.profiler``: the device's busy share over its decode
   loop.

Phase 4 runs last: the gather's launches include phase 9's retrieval,
planned from the engine's embedding of the prompts, and
``decode_attention`` is held at the inputs of phase 9's first decode
call (captured there) and at a long-context shape (B=16, S=32768).

Every kernel's launch counter is set to 0 just before each path is
driven and read just after.  The last lines are the kernels' JSON record
(launches summed over the paths that run each kernel), the
``nvidia-smi`` line, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import (torch_common, torch_quant,  # noqa: E402
                        torch_throughput)
from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core import device_store as DS  # noqa: E402
from repro_torch.core import layout as LA  # noqa: E402
from repro_torch.core import meta as ME  # noqa: E402
from repro_torch.core import scheduler as SCH  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G  # noqa: E402
from repro_torch.core.hnsw import HNSWParams, recall_at_k  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.distance_topk import ops as DO  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.gather_blocks import ops as GO  # noqa: E402
from repro_torch.kernels.gather_blocks.ref import gather_blocks_ref  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
from repro_torch.kernels.quant_topk.ref import (  # noqa: E402
    ids_agree_up_to_ties, quant_topk_ref)
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    DECODE_SPAN, DocStore, RagServeEngine)

# H100 SXM published peaks (NVIDIA datasheet), at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12

# the paper's SIFT1M run is 1M x 128-d with 500 partitions; the host-side
# index build (pure-Python HNSW, phase 3) takes 44-72 s at 100k on the
# card's host, so both are cut
REDUCED = {"n": [1_000_000, 100_000], "n_rep": [500, 256],
           "why": "host-side index build time (pure-Python HNSW)",
           "decode_32k_batch": [128, 16],
           "decode_32k_why": "decode_attention's long-context check holds "
                             "one layer's K/V and the plain version's f32 "
                             "copies of them on the card"}
FULL = dict(n=100_000, n_queries=2000, n_rep=256, k=10, doorbell=16)
SEED = 0
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-3
RECALL_FLOOR = 0.8           # sanity floor for recall@10 at full size
PAIR_BATCHES = 4             # phase 8's batches, so the tiers are reused
# phase 9: qwen3-8b at full width and depth over the 100k index
RAG_ARCH = "qwen3-8b"
RAG = dict(doc_len=240, prompt_len=64, batch=8, max_new_tokens=32,
           docs_per_query=4, n_calls=2)
DECODE_LONG = dict(B=16, S=32768)   # decode_32k's length, batch cut to 16
# decode_attention vs its plain version: in bf16 within a few bf16 steps
# of the largest output (both sides round the same f32 result once, so
# they differ by at most one step of each element); in f32 at the gpu
# tests' tolerance
BF16_STEPS = 2.0 ** -6
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls (CUDA events, after a warm-up).  A sleep kernel ahead of the
    window keeps the device busy while the host enqueues the calls, so the
    events see device time, not launch latency."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases

def phase_device() -> dict:
    """Phase 1: the card.  Raises when torch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {name} x{count} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return {"name": name, "count": count, "smi": smi}


def phase_kernel_build() -> float:
    """Phase 2: build every kernel from the checkout's sources."""
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log(f"[2 build] {len(_build.sources())} sources -> {path.name} in "
        f"{dt:.2f} s")
    return dt


def phase_index(n: int, n_queries: int, n_rep: int, *, seed: int = SEED,
                quant_group: int = 32):
    """Phase 3: the dataset, meta-HNSW and region, built once on the host
    exactly as ``ComputeClient.build`` builds them, plus a copy of the
    region with the int8 mirror attached for the int8 engines."""
    t0 = time.perf_counter()
    ds = sift_like(n=n, n_queries=n_queries, seed=seed)
    t1 = time.perf_counter()
    cfg = EngineConfig(n_rep=n_rep, seed=seed)
    meta = ME.build_meta(ds.data, cfg.n_rep, seed=cfg.seed,
                         meta_levels=cfg.meta_levels)
    store = LA.build_store(
        ds.data, meta,
        sub_params=HNSWParams(M=max(cfg.sub_M0 // 2, 2), M0=cfg.sub_M0,
                              ef_construction=cfg.ef_construction))
    t2 = time.perf_counter()
    qstore = LA.attach_quant_mirror(dataclasses.replace(store), quant_group)
    t3 = time.perf_counter()
    spec = store.spec
    log(f"[3 index] n={n} queries={n_queries} n_rep={n_rep}: data+gt "
        f"{t1 - t0:.1f} s, meta+store {t2 - t1:.1f} s, int8 mirror "
        f"{t3 - t2:.1f} s | np_max={spec.np_max} fetch_blocks="
        f"{spec.fetch_blocks} gblk={spec.gblk} vblk={spec.vblk} "
        f"n_blocks={spec.n_blocks} vec_buf={store.vec_buf.nbytes / 1e6:.1f}"
        f" MB")
    return ds, meta, store, qstore


def flat_view(qstore, device):
    """The dense-resident int8 flat database exactly as
    ``ComputeClient._sync_flat`` stages it: (codes, scales, n_valid), and
    its f32 twin: the same region rows, padded the same way."""
    spec = qstore.spec
    rows, _, _ = LA.flat_quant_rows(qstore)
    n = len(rows)
    idx = np.full(SCH.pow2_pad(max(n, 1), lo=256), -1, np.int64)
    idx[:n] = rows
    idx = torch.as_tensor(idx, dtype=torch.int32, device=device)
    codes, scales = DS.gather_quant_rows(
        torch.as_tensor(qstore.qvec_buf, device=device),
        torch.as_tensor(qstore.qscale_buf, device=device), idx,
        dim=spec.dim, group=spec.quant_group)
    vecs = DS.gather_rows(torch.as_tensor(qstore.vec_buf, device=device),
                          idx, dim=spec.dim)
    return codes, scales, vecs, n


def exact_config(n_rep: int, doorbell: int, search_mode: str = "scan",
                 gather: bool = True) -> EngineConfig:
    """The exact main path: ``mode="full"``, b=4, ef=48, RDMA fabric."""
    return EngineConfig(mode="full", search_mode=search_mode, b=4, ef=48,
                        n_rep=n_rep, doorbell=doorbell, fabric=RDMA_100G,
                        use_gather_kernel=gather)


def pairs_config(n_rep: int, doorbell: int, search_mode: str = "scan",
                 gather: bool = True) -> EngineConfig:
    """The int8 per-pair path: ``benchmarks/torch_quant.py``'s per-pair
    cell (``quant_kernel="off"``, ``cache_frac`` 0.25, ``exact_frac``
    0.25, ``rerank_m`` 0, b=6)."""
    return torch_quant.cell_config(
        quant="int8", exact_frac=0.25, rerank_m=0, n_rep=n_rep,
        quant_kernel="off", cache_frac=0.25, search_mode=search_mode,
        doorbell=doorbell, use_gather_kernel=gather)


def _route(meta, queries, device, b: int) -> np.ndarray:
    g = meta.graph
    pids, _ = S.meta_route(
        torch.as_tensor(g.vectors, dtype=torch.float32, device=device),
        torch.as_tensor(g.adjacency, dtype=torch.int32, device=device),
        torch.as_tensor(queries, dtype=torch.float32, device=device),
        int(g.entry), b=b, n_levels=g.n_levels)
    return pids.cpu().numpy()


def _round_ids(plan, store, device) -> list:
    """The block ids of each fetching round's one ``read_spans`` call."""
    return [torch.as_tensor(
        np.concatenate([store.span_block_ids(int(p)) for p in rnd.fetch_pids]),
        dtype=torch.int32, device=device)
        for rnd in plan.rounds if len(rnd.fetch_pids)]


def main_path_gathers(meta, store, queries, device, *, doorbell: int):
    """The block ids of every span read of one exact batch, round by
    round, planned as ``ComputeClient.search`` plans them on a fresh
    engine: meta-HNSW routing on ``device``, then ``plan_batch`` over an
    empty cache of ``ceil(cache_frac * n_rep)`` slots.  Each round reads
    all its fetched spans in one ``read_spans`` call, which is one gather
    launch per staged buffer.  Returns (ids per round, fetched spans)."""
    cfg = exact_config(meta.n_partitions, doorbell)
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    plan = SCH.plan_batch(_route(meta, queries, device, cfg.b),
                          SCH.LRUCacheState(cap), doorbell=cfg.doorbell)
    return _round_ids(plan, store, device), plan.n_fetches


def pair_path_gathers(meta, qstore, queries, device, *, doorbell: int,
                      search_mode: str, n_batches: int) -> list:
    """The block ids of every quantized span read of the int8 per-pair
    path over ``n_batches`` batches, planned as ``_stage1_pairs`` plans
    them on a fresh engine: each batch routed on its own, then
    ``plan_batch`` over the quantized tier, whose capacity is what
    ``_setup_quant`` gives this cell and whose state carries from batch
    to batch.  Each fetching round is one gather launch per quantized
    buffer (graph blocks, codes, scales).  Returns, per batch, (ids per
    round, fetched spans)."""
    cfg = pairs_config(meta.n_partitions, doorbell, search_mode)
    spec = qstore.spec
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    exact_cap = max(1, int(round(cap * cfg.exact_frac)))
    qpb = spec.quant_partition_bytes(include_graph=search_mode == "graph")
    cache = SCH.LRUCacheState(
        max(2, int((cap - exact_cap) * spec.partition_bytes() // qpb)))
    per = len(queries) // n_batches
    out = []
    for i in range(n_batches):
        plan = SCH.plan_batch(
            _route(meta, queries[i * per:(i + 1) * per], device, cfg.b),
            cache, doorbell=cfg.doorbell)
        out.append((_round_ids(plan, qstore, device), plan.n_fetches))
    return out


def rag_path_gathers(meta, store, queries, device, *, doorbell: int,
                     n_calls: int) -> list:
    """The block ids of every span read of phase 9's retrieval: ``n_calls``
    searches of the same embedded prompts on phase 5's exact-scan engine,
    each fused by the micro-batcher into one batch (padded to a power of
    two with copies of row 0, as ``MicroBatcher`` pads it) and planned as
    ``ComputeClient.search`` plans it, the cache carrying from call to
    call.  Returns, per call, (ids per round, fetched spans)."""
    cfg = exact_config(meta.n_partitions, doorbell)
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    cache = SCH.LRUCacheState(cap)
    pad = SCH.pow2_pad(len(queries), lo=1) - len(queries)
    fused = np.concatenate([queries, np.repeat(queries[:1], pad, axis=0)])
    out = []
    for _ in range(n_calls):
        plan = SCH.plan_batch(_route(meta, fused, device, cfg.b), cache,
                              doorbell=cfg.doorbell)
        out.append((_round_ids(plan, store, device), plan.n_fetches))
    return out


# the staged buffers each path's read_spans gathers from, in its order
EXACT_BUFS = ("graph", "vec")
PAIR_BUFS = ("graph", "codes", "scales")


def gather_launches(exact_gathers, pair_gathers, rag_gathers=()) -> list:
    """Every gather launch of the main path, as (buffer, ids): phase 5's
    counted batch in each search mode (graph, then scan), then phase 8's
    counted run in each search mode (``pair_gathers``: mode -> the
    result of ``pair_path_gathers``), then phase 9's retrieval
    (``rag_path_gathers``' result)."""
    out = [(buf, ids) for _ in ("graph", "scan")
           for ids in exact_gathers[0] for buf in EXACT_BUFS]
    for batches in pair_gathers.values():
        out += [(buf, ids) for round_ids, _ in batches
                for ids in round_ids for buf in PAIR_BUFS]
    out += [(buf, ids) for round_ids, _ in rag_gathers
            for ids in round_ids for buf in EXACT_BUFS]
    return out


def _gather_record(bufs, launches, device, timed: bool) -> dict:
    """gather_blocks vs its plain version at every launch of the main
    path (``gather_launches``), exactly equal.  The record's work is
    those launches, in the path's order: ``ms``, ``plain_ms``,
    ``library_ms`` and ``bound_ms`` are of all of them together."""
    worst = 0.0
    bound_s = 0.0
    for name, buf in bufs.items():
        row_bytes = buf.shape[1] * buf.element_size()
        for ids in {id(i): i for b, i in launches if b == name}.values():
            got = GO.gather_blocks(buf, ids)
            want = gather_blocks_ref(buf, ids)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"gather_blocks != plain on {name}")
            worst = max(worst,
                        float((got.double() - want.double()).abs().max()))
        rows = [int(ids.shape[0]) for b, ids in launches if b == name]
        nbytes = sum(2 * m * row_bytes + 4 * m for m in rows)
        bound_s += nbytes / PEAK_BYTES_S
        log(f"[4 kernels] gather_blocks {name:6s} "
            f"{str(buf.dtype).replace('torch.', ''):7s} row={row_bytes} B, "
            f"{len(rows)} launches of m={sorted(set(rows))} rows: exact "
            f"match | bound {nbytes / PEAK_BYTES_S * 1e3:.4f} ms (bytes)")
    rec = {"name": "gather_blocks", "route": "cuda",
           "source": "src/repro_torch/kernels/gather_blocks/csrc/"
                     "gather_blocks.cu",
           "replaces": "src/repro/kernels/gather_blocks/kernel.py:31",
           "launches": 0, "max_abs_err": worst, "ms": None,
           "plain_ms": None, "bound_ms": bound_s * 1e3, "bound_by": "bytes",
           "library_ms": None}
    if timed:
        work = [(bufs[b], ids) for b, ids in launches]
        outs = [torch.empty((ids.shape[0], b.shape[1]), dtype=b.dtype,
                            device=device) for b, ids in work]
        bad = torch.zeros(1, dtype=torch.int32, device=device)

        def kern():
            for (b, ids), o in zip(work, outs):
                GO._launch(b, ids, o, bad)

        def plain():
            for b, ids in work:
                gather_blocks_ref(b, ids)

        def library():
            for b, ids in work:
                torch.index_select(b, 0, ids)

        rec["ms"] = device_ms(kern, 20)
        rec["plain_ms"] = device_ms(plain, 20)
        rec["library_ms"] = device_ms(library, 20)
        if bad.item():
            raise AssertionError("gather_blocks flagged an id out of range")
    log(f"[4 kernels] gather_blocks, every launch of phases 5, 8 and 9 "
        f"({len(launches)} launches): "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"index_select {rec['library_ms']:.4f} ms, " if timed else "")
        + f"bound {rec['bound_ms']:.4f} ms (bytes)")
    return rec


def _topk_buffers(B: int, S: int, k: int, device) -> tuple:
    """The two top-k kernels' output and scratch buffers: (part_d, part_i,
    out_d, out_i) for ``S`` chunks."""
    return (torch.empty((B, S, k), dtype=torch.float32, device=device),
            torch.empty((B, S, k), dtype=torch.int32, device=device),
            torch.empty((B, k), dtype=torch.float32, device=device),
            torch.empty((B, k), dtype=torch.int32, device=device))


def _topk_check(name: str, d, i, dr, ir, kk: int) -> tuple:
    """Kernel (k) lists against the plain version's (k + 1): ids equal up
    to ties, distances within rtol 1e-5 / atol 1e-3.  Returns (max |d -
    plain|, differing tied positions)."""
    d_h, i_h = d.cpu().numpy(), i.cpu().numpy()
    dr_h, ir_h = dr.cpu().numpy(), ir.cpu().numpy()
    ok, n_diff = ids_agree_up_to_ties(i_h, ir_h, dr_h, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"{name} ids differ from plain beyond ties "
                             f"({n_diff} positions)")
    np.testing.assert_allclose(d_h, dr_h[:, :kk], rtol=TOPK_RTOL,
                               atol=TOPK_ATOL)
    return float(np.abs(d_h - dr_h[:, :kk]).max()), n_diff


def _distance_record(shapes, device, timed: bool) -> dict:
    """distance_topk against its plain version at each of ``shapes``
    ((label, q, x, n_valid, k), the first one the throughput path's), in
    f32 and on bf16 inputs (against the plain version on the same
    f32-cast inputs).  The record's numbers are the first shape's."""
    rec = {"name": "distance_topk", "route": "cuda",
           "source": "src/repro_torch/kernels/distance_topk/csrc/"
                     "distance_topk.cu",
           "replaces": "src/repro/kernels/distance_topk/kernel.py:87",
           "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None}
    for j, (label, q, x, nv, k) in enumerate(shapes):
        (B, D), N = q.shape, x.shape[0]
        kk = min(k, nv)
        err, n_diff = _topk_check(
            "distance_topk", *DO.distance_topk(q, x, kk, n_valid=nv),
            *distance_topk_ref(q, x, min(kk + 1, N), nv), kk)
        qb, xb = q.bfloat16(), x.bfloat16()
        err_b, n_diff_b = _topk_check(
            "distance_topk (bf16)", *DO.distance_topk(qb, xb, kk, n_valid=nv),
            *distance_topk_ref(qb.float(), xb.float(), min(kk + 1, N), nv),
            kk)
        flops = 2.0 * B * nv * D
        nbytes = B * D * 4 + nv * D * 4 + B * kk * 8
        bound_by = ("operations" if flops / PEAK_F32_FLOPS_S
                    >= nbytes / PEAK_BYTES_S else "bytes")
        bound_ms = max(flops / PEAK_F32_FLOPS_S, nbytes / PEAK_BYTES_S) * 1e3
        ms = plain_ms = None
        if timed:
            S = QO.n_chunks(B, nv)
            bufs = _topk_buffers(B, S, kk, device)
            ms = device_ms(lambda: DO._launch(q, x, kk, nv, *bufs, S), 20)
            plain_ms = device_ms(lambda: distance_topk_ref(q, x, kk, nv), 5)
        rec["max_abs_err"] = max(rec["max_abs_err"], err, err_b)
        if j == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[4 kernels] distance_topk {label} B={B} N={N} n_valid={nv} "
            f"D={D} k={kk}: ids equal up to ties ({n_diff} tied positions "
            f"differ; bf16 inputs {n_diff_b}), max |d - plain| "
            f"{max(err, err_b):.3g} | "
            + (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, " if timed
               else "")
            + f"library none (no single torch call computes distance plus "
              f"top-k), bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.2f} GFLOP)")
    return rec


def long_decode_inputs(B: int, S: int, H: int, K: int, hd: int, dtype,
                       device, seed: int = SEED) -> tuple:
    """decode_attention's long-context inputs: q (B, H, hd), k/v (B, S, K,
    hd) drawn from a seeded generator on ``device``, pos = S."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    return q, k, v, torch.full((B,), S, dtype=torch.int32, device=device)


def _sdpa(q, kt, vt, mask):
    """The library call: one ``scaled_dot_product_attention`` with GQA and
    a length mask, on k/v laid out (B, K, S, hd)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0]


def _decode_checks(q, k, v, pos, route: bool) -> tuple:
    """decode_attention against its plain version on (q, k, v, pos): in
    bf16 within ``BF16_STEPS`` of the largest plain output, and on f32
    copies of the inputs at ``F32_TOL``.  With ``route``, also against
    ``attend_decode`` at pos - 1, the call the decode route replaces: in
    f32 at ``F32_TOL``, and in bf16 within the bound of attend_decode's
    one extra rounding (p cast to bf16 before the PV product moves the
    output by at most 2^-9 of max |v| over the valid entries) plus the
    same output steps.  Returns (max |out - plain| in q's dtype, the
    plain output in f32, the log text)."""
    got = DA.decode_attention(q, k, v, pos).float()
    want = decode_attention_ref(q, k, v, pos).to(q.dtype).float()
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    line = f"max |plain| {peak:.3g}"
    lim = BF16_STEPS * peak
    if q.dtype == torch.bfloat16:
        if err > lim:
            raise AssertionError(f"decode_attention: max |out - plain| "
                                 f"{err:.3g} > {lim:.3g} in bf16")
        line += f", max |out - plain| {err:.3g} (limit {lim:.3g})"
    f32 = [t.float() for t in (q, k, v)]
    got32, want32 = (DA.decode_attention(*f32, pos),
                     decode_attention_ref(*f32, pos))
    if not torch.allclose(got32, want32, **F32_TOL):
        raise AssertionError("decode_attention != plain in f32")
    line += f", f32 max |out - plain| {float((got32 - want32).abs().max()):.3g}"
    if route:
        r32 = LY.attend_decode(*f32, pos - 1)
        if not torch.allclose(got32, r32, **F32_TOL):
            raise AssertionError("decode_attention at pos + 1 != "
                                 "attend_decode at pos, in f32")
        line += (f", f32 max |out - attend_decode(pos - 1)| "
                 f"{float((got32 - r32).abs().max()):.3g}")
        if q.dtype == torch.bfloat16:
            n = int(pos.max())
            r_lim = 2.0 ** -9 * float(v[:, :n].float().abs().max()) + lim
            r_err = float((got - LY.attend_decode(q, k, v, pos - 1).float())
                          .abs().max())
            if r_err > r_lim:
                raise AssertionError(f"decode_attention at pos + 1: max |out"
                                     f" - attend_decode(pos)| {r_err:.3g} > "
                                     f"{r_lim:.3g} in bf16")
            line += (f", max |out - attend_decode(pos - 1)| {r_err:.3g} "
                     f"(limit {r_lim:.3g})")
    del f32, got32, want32
    return err, want, line


def _decode_record(shapes, device, timed: bool) -> dict:
    """decode_attention against its plain version at each of ``shapes``
    ((label, q, k, v, pos), the first one the decode path's), as
    ``_decode_checks`` holds it; at the path's shape also against
    ``attend_decode`` at pos - 1.  Timed over copies that together
    exceed the 50 MB L2 (the path finds each layer's cache cold: the
    whole model's weights stream between two calls on one layer).  The
    record's numbers are the first shape's."""
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/decode_attention/csrc/"
                     "decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/kernel.py:77",
           "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": "bytes", "library_ms": None}
    for j, (label, q, k, v, pos) in enumerate(shapes):
        B, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        err, want, line = _decode_checks(q, k, v, pos, route=j == 0)
        valid = int(torch.clamp(pos, 0, S).sum())
        nbytes = (2 * valid * K * hd * k.element_size()
                  + 2 * q.numel() * q.element_size() + 4 * B)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        ms = plain_ms = lib_ms = None
        if timed:
            n_copy = max(1, -(-64_000_000 // (2 * k.numel() *
                                              k.element_size())))
            sets = [(q, k, v, pos)] + [(q, k.clone(), v.clone(), pos)
                                       for _ in range(n_copy - 1)]
            bufs = [DA.buffers(q, kk) for _, kk, _, _ in sets]
            ms = device_ms(lambda: [DA._launch(*a, *b) for a, b in
                                    zip(sets, bufs)], 20) / n_copy
            plain_ms = device_ms(lambda: [decode_attention_ref(*a)
                                          for a in sets], 3) / n_copy
            mask = (torch.arange(S, device=device)[None, :]
                    < pos[:, None])[:, None, None, :]
            lib = [(q, kk.transpose(1, 2).contiguous(),
                    vv.transpose(1, 2).contiguous(), mask)
                   for _, kk, vv, _ in sets]
            try:
                lib_err = float((_sdpa(*lib[0]).float() - want).abs().max())
                lib_ms = device_ms(lambda: [_sdpa(*a) for a in lib],
                                   5) / n_copy
                line += f", SDPA max |out - plain| {lib_err:.3g}"
            except RuntimeError as e:
                line += f", SDPA refused these inputs: {e}"
            del sets, bufs, lib
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if j == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       library_ms=lib_ms)
        log(f"[4 kernels] decode_attention {label} B={B} H={H} K={K} "
            f"hd={hd} S={S} pos={sorted(set(pos.tolist()))} "
            f"{str(q.dtype).replace('torch.', '')}: {line} | "
            + (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
               + (f"{lib_ms:.4f} ms, " if lib_ms is not None else "none, ")
               if timed else "")
            + f"bound {bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB)")
    return rec


def phase_kernels(store, qstore, data, queries, launches, device, *,
                  k: int = 20, decode_shapes=()) -> list:
    """Phase 4: each kernel against its plain version at the paths'
    shapes.  gather_blocks: every launch of phases 5, 8 and 9
    (``gather_launches``) on its staged buffer (int32 graph blocks, f32
    vector blocks, int8 codes, f32 scales), exactly equal.  quant_topk:
    the flat stage-1 call (all queries against the padded flat int8
    database).  distance_topk: the throughput benchmark's call
    (``queries[:128]`` x ``data[:4096]``, k=10) and the flat f32 twin of
    the quant_topk call.  Top-k ids equal up to ties and distances within
    rtol 1e-5 / atol 1e-3.  decode_attention: ``decode_shapes`` (see
    ``_decode_record``), when given.  Times only on the card."""
    timed = device.type == "cuda"
    bufs = {"graph": torch.as_tensor(store.graph_buf, device=device),
            "vec": torch.as_tensor(store.vec_buf, device=device),
            "codes": torch.as_tensor(qstore.qvec_buf, device=device),
            "scales": torch.as_tensor(qstore.qscale_buf, device=device)}
    records = [_gather_record(bufs, launches, device, timed)]

    codes, scales, vecs, n_valid = flat_view(qstore, device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    group = qstore.spec.quant_group
    B, D = q.shape
    kk = min(k, n_valid)
    q_err, n_diff = _topk_check(
        "quant_topk", *QO.quant_topk(q, codes, scales, kk, group,
                                     n_valid=n_valid),
        *quant_topk_ref(q, codes, scales, kk + 1, group, n_valid), kk)
    flops = 2.0 * B * n_valid * D
    nbytes = (B * D * 4 + n_valid * D + n_valid * (D // group) * 4
              + B * kk * 8)
    rec = {"name": "quant_topk", "route": "cuda",
           "source": "src/repro_torch/kernels/quant_topk/csrc/quant_topk.cu",
           "replaces": "src/repro/kernels/quant_topk/kernel.py:72",
           "launches": 0, "max_abs_err": q_err, "ms": None,
           "plain_ms": None,
           "bound_ms": max(flops / PEAK_F32_FLOPS_S,
                           nbytes / PEAK_BYTES_S) * 1e3,
           "bound_by": ("operations" if flops / PEAK_F32_FLOPS_S
                        >= nbytes / PEAK_BYTES_S else "bytes"),
           "library_ms": None}
    if timed:
        S = QO.n_chunks(B, n_valid)
        bufs_q = _topk_buffers(B, S, kk, device)
        rec["ms"] = device_ms(lambda: QO._launch(
            q, codes, scales, kk, group, n_valid, *bufs_q, S), 20)
        rec["plain_ms"] = device_ms(lambda: quant_topk_ref(
            q, codes, scales, kk, group, n_valid), 5)
    records.append(rec)
    log(f"[4 kernels] quant_topk B={B} N={codes.shape[0]} n_valid={n_valid}"
        f" D={D} group={group} k={kk}: ids equal up to ties ({n_diff} tied"
        f" positions differ), max |d - plain| {q_err:.3g} | "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           if timed else "")
        + f"library none, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}, {flops / 1e9:.1f} GFLOP)")
    x_small = torch.as_tensor(data[:4096], device=device)
    records.append(_distance_record(
        [("throughput", q[:128], x_small, x_small.shape[0], 10),
         ("flat f32", q, vecs, n_valid, k)], device, timed))
    if decode_shapes:
        records.append(_decode_record(decode_shapes, device, timed))
    return records


KERNEL_OPS = {"gather_blocks": GO, "quant_topk": QO, "distance_topk": DO,
              "decode_attention": DA}


def _reset_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.launches = 0


def _launches() -> dict:
    return {name: ops.launches for name, ops in KERNEL_OPS.items()}


def _search(eng, queries, k: int, device):
    """One main-path batch: every launch count is set to 0 just before it
    and read just after.  Returns (d, g, stats, wall s, launches)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    d, g, st = eng.search(queries, k=k)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return d, g, st, wall, _launches()


def _in_turns(make_engine, variants, queries, k: int, device,
              n_batches: int = 1) -> dict:
    """Search the queries in ``n_batches`` batches with a fresh engine per
    variant, in turns (a, b, b, a), so that neither variant alone pays the
    warm-up.  Returns variant -> the first run's batches, each (d, g,
    stats, wall s, launches), and every run's batch walls."""
    per = len(queries) // n_batches
    out = {}
    for v in (*variants, *variants[::-1]):
        eng = make_engine(v)
        runs = [_search(eng, queries[i * per:(i + 1) * per], k, device)
                for i in range(n_batches)]
        walls = [r[3] for r in runs]
        if v in out:
            out[v]["walls"].append(walls)
        else:
            out[v] = {"batches": runs, "walls": [walls]}
    return out


def _host_split(st) -> str:
    return (f"route {st['meta_s']:.3f} s, plan {st['plan_s']:.3f} s, "
            f"serve {st['sub_s']:.3f} s")


def _counted_equal(st, other) -> bool:
    """The counted stats of two searches are equal."""
    keys = ("net", "n_rounds", "n_pairs", "cache_hits", "n_fetches",
            "rerank_rows", "rerank_hit_rows", "exact_admitted")
    return all(st.get(key) == other.get(key) for key in keys)


def _check_output(d, g, B: int, k: int, n: int, what: str) -> None:
    if d.shape != (B, k) or g.shape != (B, k):
        raise AssertionError(f"{what}: shapes {d.shape} {g.shape}")
    if not np.isfinite(d).all():
        raise AssertionError(f"{what}: non-finite distances")
    if not ((g >= 0) & (g < n)).all():
        raise AssertionError(f"{what}: gids outside [0, {n})")


def _counted(st) -> str:
    net = st["net"]
    return (f"net trips={net['round_trips']} descs={net['descriptors']} "
            f"bytes={net['bytes']:.0f} saved={net['bytes_saved']:.0f} | "
            f"rounds={st['n_rounds']} pairs={st['n_pairs']} "
            f"cache_hits={st['cache_hits']} fetches={st['n_fetches']}")


def phase_exact(ds, meta, store, device, *, k: int, doorbell: int,
                gathers, recall_floor: float = 0.0) -> dict:
    """Phase 5: exact search through the CUDA doorbell gather, held
    against the same engine with the gather off (an exact copy, so the
    results must be equal).  ``gathers`` is ``main_path_gathers``' result:
    each batch must fetch the spans it planned, in one gather launch per
    staged buffer and round, so phase 4 timed the launches made here.
    Returns the gather launches of the path and the scan batch's stats."""
    launches = 0
    round_ids, n_fetches = gathers
    B, n = ds.queries.shape[0], ds.data.shape[0]
    for search_mode in ("graph", "scan"):
        def make(gather, search_mode=search_mode):
            cfg = exact_config(meta.n_partitions, doorbell, search_mode,
                               gather)
            return DHNSWEngine(cfg, device=device).adopt_built(
                meta, dataclasses.replace(store), ds.data)
        outs = _in_turns(make, (False, True), ds.queries, k, device)
        on, off = outs[True], outs[False]
        d, g, st, _, n_on = on["batches"][0]
        d0, g0, _, _, n_off = off["batches"][0]
        n_launch = n_on["gather_blocks"]
        if n_off["gather_blocks"]:
            raise AssertionError("gather_blocks launched with the gather off")
        want = len(EXACT_BUFS) * len(round_ids) if device.type == "cuda" else 0
        if n_launch != want or st["n_fetches"] != n_fetches:
            raise AssertionError(
                f"exact {search_mode}: {n_launch} gather launches and "
                f"{st['n_fetches']} fetches, planned {want} and {n_fetches}")
        launches += n_launch
        _check_output(d, g, B, k, n, f"exact {search_mode}")
        if not (np.array_equal(g, g0) and np.array_equal(d, d0)):
            raise AssertionError(f"exact {search_mode}: gather kernel on/off "
                                 "results differ")
        rec = recall_at_k(g, ds.gt_ids[:, :k])
        if rec < recall_floor:
            raise AssertionError(f"exact {search_mode}: recall@{k} {rec}")
        log(f"[5 exact {search_mode}] recall@{k}={rec:.4f} | {_counted(st)}"
            f" | gather launches {n_launch} | wall s gather on "
            f"{[w[0] for w in on['walls']]}, off "
            f"{[w[0] for w in off['walls']]} (off, on, on, off) | host "
            f"split (on, first run): {_host_split(st)} | equal to gather off")
    return {"gather_blocks": launches}, st


def phase_int8(ds, meta, qstore, device, *, k: int, doorbell: int,
               recall_floor: float = 0.0) -> dict:
    """Phase 6: int8 staged search with the flat stage 1 through the CUDA
    ``quant_topk`` ("auto"), held against the plain stage 1 ("ref")."""
    B, n = ds.queries.shape[0], ds.data.shape[0]

    def make(qk):
        cfg = EngineConfig(mode="full", search_mode="scan", b=6,
                           n_rep=meta.n_partitions, quant="int8",
                           quant_kernel=qk, cache_frac=0.6, exact_frac=0.25,
                           doorbell=doorbell, fabric=RDMA_100G)
        return DHNSWEngine(cfg, device=device).adopt_built(
            meta, dataclasses.replace(qstore), ds.data)
    outs = _in_turns(make, ("ref", "auto"), ds.queries, k, device)
    auto, ref = outs["auto"], outs["ref"]
    d, g, st, _, n_auto = auto["batches"][0]
    dr, gr, sr, _, n_ref = ref["batches"][0]
    launches = n_auto["quant_topk"]
    want = "cuda" if device.type == "cuda" else "ref"
    if st["stage1_impl"] != want or sr["stage1_impl"] != "ref":
        raise AssertionError(f"stage1_impl {st['stage1_impl']} / "
                             f"{sr['stage1_impl']}")
    if device.type == "cuda" and launches == 0:
        raise AssertionError("quant_topk was not launched")
    if n_ref["quant_topk"]:
        raise AssertionError("quant_topk launched under quant_kernel='ref'")
    _check_output(d, g, B, k, n, "int8 flat")
    # the reference list for ties: the plain run's own top-k, extended by
    # one rank of +inf so the last place can only differ at a tie
    ext_d = np.concatenate([dr, np.full((B, 1), np.inf, np.float32)], 1)
    ext_g = np.concatenate([gr, np.full((B, 1), -1, gr.dtype)], 1)
    ok, n_diff = ids_agree_up_to_ties(g, ext_g, ext_d, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"int8 flat: gids differ from the plain stage "
                             f"1 beyond ties ({n_diff} positions)")
    np.testing.assert_allclose(d, dr, rtol=TOPK_RTOL, atol=TOPK_ATOL)
    rec = recall_at_k(g, ds.gt_ids[:, :k])
    if rec < recall_floor:
        raise AssertionError(f"int8 flat: recall@{k} {rec}")
    log(f"[6 int8 flat] recall@{k}={rec:.4f} (ref stage 1: "
        f"{recall_at_k(gr, ds.gt_ids[:, :k]):.4f}) | {_counted(st)} | "
        f"stage1_impl={st['stage1_impl']} flat_rows={st['flat_rows']} "
        f"rerank_rows={st['rerank_rows']} | quant_topk launches {launches}"
        f" | wall s auto {[w[0] for w in auto['walls']]}, ref "
        f"{[w[0] for w in ref['walls']]} (ref, auto, "
        f"auto, ref) | host split (auto, first run): {_host_split(st)} | "
        f"{n_diff} positions differ from the ref, all at ties")
    return {"quant_topk": launches}


def phase_throughput(ds, meta, store, device, *, preset: dict,
                     scan_stats) -> dict:
    """Phase 7: ``benchmarks/torch_throughput.run`` on the index of phase
    3.  Its doorbell-16 row is the first batch of ``preset["batch"]``
    queries on a fresh scan engine with ``cache_frac`` 0.10, as phase 5's
    exact scan batch is, so it must count the same trips, bytes, hits and
    fetches.  Returns the path's kernel launches."""
    log(f"[7 throughput] benchmarks/torch_throughput.py, preset "
        f"{json.dumps(preset)}:")
    if device.type == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    rows = torch_throughput.run((meta, store, ds.data), preset=preset, ds=ds,
                                device=device)
    wall = time.perf_counter() - t0
    launches = _launches()
    if device.type == "cuda" and launches["distance_topk"] == 0:
        raise AssertionError("distance_topk was not launched on the "
                             "throughput path")
    db16 = next(r for r in rows if r["name"] == "doorbell/width16")
    net = scan_stats["net"]
    want = {"trips": net["round_trips"], "bytes": int(net["bytes"]),
            "hits": scan_stats["cache_hits"],
            "fetches": scan_stats["n_fetches"]}
    got = {key: db16[key] for key in want}
    if got != want:
        raise AssertionError(f"doorbell/width16 counted {got}, the exact scan"
                             f" batch of phase 5 {want}")
    log(f"[7 throughput] {len(rows)} rows in {wall:.1f} s | doorbell/width16 "
        f"counts what phase 5's scan batch counted {want} | launches "
        f"{launches}")
    return {"distance_topk": launches["distance_topk"]}


def phase_int8_pairs(ds, meta, qstore, device, *, k: int, doorbell: int,
                     gathers, n_batches: int = PAIR_BATCHES,
                     recall_floor: float = 0.0) -> dict:
    """Phase 8: int8 search through the per-pair stage 1
    (``pairs_config``) in both search modes over the queries in
    ``n_batches`` batches, so the tiers are reused.  Each mode runs with
    the CUDA gather and is held against the same engine with the gather
    off, in turns (an exact copy: gids, distances and counted stats
    equal).  ``gathers`` maps each mode to ``pair_path_gathers``' result:
    each batch must fetch the spans it planned, in one gather launch per
    quantized buffer and round, so phase 4 checked and timed the launches
    made here.  Returns the gather launches of the path."""
    B, n = ds.queries.shape[0], ds.data.shape[0]
    per = B // n_batches
    launches = 0
    for search_mode in ("scan", "graph"):
        def make(gather, search_mode=search_mode):
            cfg = pairs_config(meta.n_partitions, doorbell, search_mode,
                               gather)
            return DHNSWEngine(cfg, device=device).adopt_built(
                meta, dataclasses.replace(qstore), ds.data)
        outs = _in_turns(make, (False, True), ds.queries, k, device,
                         n_batches=n_batches)
        on, off = outs[True], outs[False]
        recs = []
        n_mode = 0
        for i, ((d, g, st, _, n_on), (d0, g0, st0, _, n_off),
                (round_ids, n_fetches)) in enumerate(zip(
                    on["batches"], off["batches"], gathers[search_mode])):
            what = f"int8 pairs {search_mode} batch {i}"
            if n_off["gather_blocks"]:
                raise AssertionError("gather_blocks launched with the gather "
                                     "off")
            if st["exact_admitted"]:
                raise AssertionError(
                    f"{what}: {st['exact_admitted']} spans admitted to the "
                    "exact tier, whose reads phase 4 did not plan")
            want = (len(PAIR_BUFS) * len(round_ids)
                    if device.type == "cuda" else 0)
            if n_on["gather_blocks"] != want or st["n_fetches"] != n_fetches:
                raise AssertionError(
                    f"{what}: {n_on['gather_blocks']} gather launches and "
                    f"{st['n_fetches']} fetches, planned {want} and "
                    f"{n_fetches}")
            n_mode += n_on["gather_blocks"]
            _check_output(d, g, per, k, n, what)
            if not (np.array_equal(g, g0) and np.array_equal(d, d0)
                    and _counted_equal(st, st0)):
                raise AssertionError(f"{what}: gather kernel on/off results "
                                     "differ")
            if "stage1_impl" in st or "quant_kernel" in st:
                raise AssertionError("the per-pair route names a stage 1")
            recs.append(recall_at_k(g, ds.gt_ids[i * per:(i + 1) * per, :k]))
            log(f"[8 int8 pairs {search_mode}] batch {i} of {per}: "
                f"{_counted(st)} | rerank_rows={st['rerank_rows']} "
                f"hit_rows={st['rerank_hit_rows']} admitted="
                f"{st['exact_admitted']} | gather launches "
                f"{n_on['gather_blocks']} | wall s gather on "
                f"{[w[i] for w in on['walls']]}, off "
                f"{[w[i] for w in off['walls']]} (off, on, on, off) | host "
                f"split (on, first run): {_host_split(st)}")
        rec = float(np.mean(recs))
        if rec < recall_floor:
            raise AssertionError(f"int8 pairs {search_mode}: recall@{k} {rec}")
        launches += n_mode
        log(f"[8 int8 pairs {search_mode}] recall@{k}={rec:.4f} over "
            f"{n_batches} batches | gather launches {n_mode} | wall s of the "
            f"{n_batches} batches gather on "
            f"{[sum(w) for w in on['walls']]}, off "
            f"{[sum(w) for w in off['walls']]} | equal to gather off")
    return {"gather_blocks": launches}


class FirstCall:
    """While active, records (cloned) the arguments of the first call of
    ``module.name``; every call still goes through to the real function,
    so its launches count as before."""

    def __init__(self, module, name: str):
        self.module, self.name, self.args = module, name, None

    def __enter__(self) -> "FirstCall":
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *args, **kw):
        if self.args is None:
            self.args = tuple(a.clone() for a in args)
        return self.real(*args, **kw)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.real)


def _busy_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_serve(eng, prompts, decode_s: float) -> None:
    """One more ``eng.serve(prompts)`` under ``torch.profiler`` (CPU and
    CUDA activity): the device's busy share over the decode loop, the
    window the engine marks with ``DECODE_SPAN``, and the kernels' device
    time by name inside it.  ``decode_s`` is an unprofiled call's decode
    time (the same work: the same prompts and tokens), printed beside the
    profiled one as the profiler's cost; the device's busy time is held
    against both, since the profiler's host tracing slows only the
    host.  Prints
    "not measured" when the profiler records no device event.  Its
    launches are not the main path's: the caller sets the counts to 0
    afterwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = eng.device.type == "cuda"
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        eng.serve(prompts)
    # the raw events: building prof.events()' tree takes tens of seconds at
    # this count (some 3000 host operations and as many kernels a step)
    events = [(e.name(), e.device_type(), e.start_ns() / 1e3,
               e.end_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    spans = [(s, t) for name, dt, s, t in events
             if name == DECODE_SPAN and dt == DeviceType.CPU]
    if len(spans) != 1:
        raise AssertionError(f"rag profile: {len(spans)} {DECODE_SPAN} "
                             f"ranges, want 1")
    a, b = spans[0]
    kern = [(name, max(s, a), min(t, b)) for name, dt, s, t in events
            if dt == DeviceType.CUDA and name != DECODE_SPAN and t > a
            and s < b]
    n_steps, wall_us = eng.max_new_tokens, b - a
    head = (f"[9 rag] decode profile: one more serve call, {n_steps} steps "
            f"in {wall_us / 1e3:.3f} ms ({wall_us / n_steps / 1e3:.3f} ms a "
            f"step profiled, {decode_s / n_steps * 1e3:.3f} ms unprofiled), "
            f"profiled and read in {time.perf_counter() - t0:.1f} s")
    if not kern:
        log(f"{head}; device busy share not measured (the profiler recorded "
            f"no device event)")
        return
    busy = _busy_us([(s, t) for _, s, t in kern])
    by: dict = {}          # kernel name -> [device us, count]
    for name, s, t in kern:
        name = ("decode_attention (both passes)"
                if "decode_split" in name or "decode_combine" in name
                else name[:48])
        acc = by.setdefault(name, [0.0, 0])
        acc[0] += t - s
        acc[1] += 1
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:6]
    att_us, att_n = by.get("decode_attention (both passes)", [0.0, 0])
    log(f"{head} | {len(kern)} device events | device busy "
        f"{busy / 1e3:.3f} ms ({busy / n_steps / 1e3:.3f} ms a step): busy "
        f"share {busy / wall_us:.4f} of the profiled window (idle "
        f"{1 - busy / wall_us:.4f}), {busy / (decode_s * 1e6):.4f} of the "
        f"unprofiled call's decode time (idle "
        f"{1 - busy / (decode_s * 1e6):.4f}) | decode_attention {att_us / 1e3:.3f} ms "
        f"in {att_n // 2} launches, {2 * att_us / max(att_n, 1):.2f} us each "
        f"(on the path's cold caches) | device ms by kernel, top 6: "
        + "; ".join(f"{k} {v[0] / 1e3:.3f} ({v[1]})" for k, v in top))


def _rag_calls(eng, prompts, gathers, capture, *, want_decode: int,
               on_card: bool) -> tuple:
    """Phase 9's counted ``serve`` calls, one per entry of ``gathers``
    (``rag_path_gathers``' plan), the first under ``capture``.  Each call
    is checked against its plan and ``want_decode`` decode_attention
    launches.  Returns (tokens per call, launches summed, the last call's
    decode seconds)."""
    cfg = eng.cfg
    B, Sp = prompts.shape
    S = eng.docs_per_query * eng.docs.tokens.shape[1] + Sp
    n_new = eng.max_new_tokens
    outs, launches = [], {name: 0 for name in KERNEL_OPS}
    for i, (round_ids, n_fetches) in enumerate(gathers):
        if on_card:
            torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            with capture:
                out, st = eng.serve(prompts)
        else:
            out, st = eng.serve(prompts)
        wall = time.perf_counter() - t0
        n = _launches()
        r = st.retrieval
        want_gather = len(EXACT_BUFS) * len(round_ids) if on_card else 0
        if n["decode_attention"] != want_decode:
            raise AssertionError(f"rag call {i}: {n['decode_attention']} "
                                 f"decode_attention launches, want "
                                 f"{want_decode}")
        if n["gather_blocks"] != want_gather or r["n_fetches"] != n_fetches:
            raise AssertionError(
                f"rag call {i}: {n['gather_blocks']} gather launches and "
                f"{r['n_fetches']} fetches, planned {want_gather} and "
                f"{n_fetches}")
        if out.shape != (B, n_new) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"rag call {i}: tokens {out.shape} out of "
                                 f"range")
        outs.append(out)
        for key in launches:
            launches[key] += n[key]
        net = r["net"]
        log(f"[9 rag] call {i}: wall {wall:.4f} s = retrieve "
            f"{st.retrieve_s:.4f} s + prefill {st.prefill_s:.4f} s (S={S}) "
            f"+ decode {st.decode_s:.4f} s ({B * n_new / st.decode_s:.1f} "
            f"tokens/s, {st.decode_s / n_new * 1e3:.3f} ms a step) | "
            f"retrieval: trips={net['round_trips']} bytes={net['bytes']:.0f}"
            f" fetches={r['n_fetches']} cache_hits={r['cache_hits']} | "
            f"launches {n}")
    return outs, launches, st.decode_s


def phase_rag(ds, meta, store, device, *, cfg, doorbell: int, doc_len: int,
              prompt_len: int, batch: int, max_new_tokens: int,
              docs_per_query: int, n_calls: int, seed: int = SEED) -> tuple:
    """Phase 9: ``RagServeEngine.serve`` with ``cfg`` over phase 5's
    exact-scan engine (the CUDA gather on), whose indexed vectors are the
    documents' embeddings; each document is ``doc_len`` tokens drawn with
    numpy from the seed, and so are the ``batch`` prompts.  ``n_calls``
    calls serve the same prompts: the tokens must be in range and equal
    across calls, every decode layer of a window-free, softcap-free model
    must go through ``decode_attention`` (``n_layers * max_new_tokens``
    launches a call on the card), and each call's retrieval must fetch
    the spans ``rag_path_gathers`` planned, in one gather launch per
    staged buffer and round.  Then ``profile_serve`` measures the
    device's busy share over the decode loop of one more call (not
    counted).  Returns (launches, the planned gathers, the inputs of the
    first decode_attention call)."""
    rng = np.random.default_rng(seed)
    docs = DocStore(ds.data, rng.integers(0, cfg.vocab_size,
                                          (len(ds.data), doc_len),
                                          dtype=np.int32))
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    retriever = DHNSWEngine(exact_config(meta.n_partitions, doorbell, "scan"),
                            device=device).adopt_built(
        meta, dataclasses.replace(store), ds.data)
    t0 = time.perf_counter()
    eng = RagServeEngine(cfg, retriever, docs, max_new_tokens=max_new_tokens,
                         docs_per_query=docs_per_query, seed=seed,
                         device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [*eng.params["blocks"].values(), eng.params["embed"],
                   eng.params["final_norm"], eng.params["unembed"]])
    log(f"[9 rag] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.the_head_dim()}, vocab "
        f"{cfg.vocab_size}: weights {n_bytes / 1e9:.2f} GB drawn on "
        f"{device} in {time.perf_counter() - t0:.2f} s | docs "
        f"{len(ds.data)} x {doc_len} tokens, prompts {batch} x {prompt_len},"
        f" {docs_per_query} docs a prompt, {max_new_tokens} new tokens")
    gathers = rag_path_gathers(meta, store, eng._embed(prompts), device,
                               doorbell=doorbell, n_calls=n_calls)
    on_card = device.type == "cuda"
    want_decode = cfg.n_layers * max_new_tokens if on_card else 0
    capture = FirstCall(DA, "decode_attention")
    try:
        outs, launches, decode_s = _rag_calls(
            eng, prompts, gathers, capture, want_decode=want_decode,
            on_card=on_card)
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise AssertionError("rag: the calls generated different tokens")
        if on_card and launches["gather_blocks"] == 0:
            raise AssertionError("rag: the gather kernel did not launch on "
                                 "the retrieval")
        log(f"[9 rag] {n_calls} calls generated equal tokens; first "
            f"sequence {outs[0][0][:8].tolist()}... | launches {launches}")
        profile_serve(eng, prompts, decode_s)
    finally:
        eng.close()
    _reset_launches()
    del eng
    if on_card:
        torch.cuda.empty_cache()
    return launches, gathers, capture.args


def main() -> int:
    dev_info = phase_device()
    device = torch.device("cuda")
    log("reduced: " + json.dumps(REDUCED))
    phase_kernel_build()
    ds, meta, store, qstore = phase_index(FULL["n"], FULL["n_queries"],
                                          FULL["n_rep"])
    gathers = main_path_gathers(meta, store, ds.queries, device,
                                doorbell=FULL["doorbell"])
    pair_gathers = {mode: pair_path_gathers(
        meta, qstore, ds.queries, device, doorbell=FULL["doorbell"],
        search_mode=mode, n_batches=PAIR_BATCHES) for mode in ("scan", "graph")}
    launches, scan_stats = phase_exact(
        ds, meta, store, device, k=FULL["k"], doorbell=FULL["doorbell"],
        gathers=gathers, recall_floor=RECALL_FLOOR)
    launches.update(phase_int8(ds, meta, qstore, device, k=FULL["k"],
                               doorbell=FULL["doorbell"],
                               recall_floor=RECALL_FLOOR))
    launches.update(phase_throughput(
        ds, meta, store, device, preset=torch_common.PRESETS["full"],
        scan_stats=scan_stats))
    pairs = phase_int8_pairs(ds, meta, qstore, device, k=FULL["k"],
                             doorbell=FULL["doorbell"], gathers=pair_gathers,
                             n_batches=PAIR_BATCHES,
                             recall_floor=RECALL_FLOOR)
    launches["gather_blocks"] += pairs["gather_blocks"]
    rag_launches, rag_gathers, first = phase_rag(
        ds, meta, store, device, cfg=get_config(RAG_ARCH),
        doorbell=FULL["doorbell"], **RAG)
    launches["gather_blocks"] += rag_launches["gather_blocks"]
    launches["decode_attention"] = rag_launches["decode_attention"]
    planned = gather_launches(gathers, pair_gathers, rag_gathers)
    if launches["gather_blocks"] != len(planned):
        raise AssertionError(f"{launches['gather_blocks']} gather launches on "
                             f"the main path, {len(planned)} planned")
    q, k, v, pos = first
    records = phase_kernels(store, qstore, ds.data, ds.queries, planned,
                            device, decode_shapes=[
                                ("path", q, k, v, pos),
                                ("long", *long_decode_inputs(
                                    **DECODE_LONG, H=q.shape[1],
                                    K=k.shape[2], hd=q.shape[2],
                                    dtype=q.dtype, device=device))])
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} not launched on the main path")
    log(json.dumps({"kernels": records}))
    log(dev_info["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev_info["name"],
                                           "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

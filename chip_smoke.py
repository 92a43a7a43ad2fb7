#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of d-HNSW once on one NVIDIA GPU.

    python3 chip_smoke.py [--sweep]

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
   library call's time (for the top-k kernels the cuBLAS product alone);
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
   loop;
10. insert at full size, on deep copies of phase 3's region: the
    exact-scan engine of phase 5 and the int8 flat engine of phase 6 each
    insert 256 held-out queries, then a burst of ``ov_cap + 8`` near
    copies of one base row that fills its group's overflow region and
    repacks it; a ``device="cpu"`` engine runs the same inserts.  Gids,
    verb counts and the insert ledger against the charge rule, the
    device region against the host's after the inserts and after the
    repack, the flat view against a fresh sync, routing against the CPU
    engine, self-recall@1, recall@10 against brute force over the grown
    data, and an int8 search at ``rerank_m=256`` (``quant_topk``'s
    large-k route); time an insert split into route, host write and
    device twin, the repack, and the searches after it;
11. bulk load: ``DHNSWEngine.build_streaming`` at ``benchmarks/
    ingest.py``'s full ``run_load`` geometry (20 000 rows, 64
    partitions, 8 chunks) against ``build`` of the same data, both
    serving on the card: meta, regions and a search of 500 queries
    bit-identical, and the ``LoadReport``'s counts.

Phase 4 runs last: the gather's launches include phase 9's retrieval,
planned from the engine's embedding of the prompts, and the launches of
the searches of phases 10 and 11 (recorded there, on the buffers they
read); ``decode_attention`` is held at the inputs of phase 9's first
decode call (captured there) and at a long-context shape (B=16,
S=32768); ``quant_topk`` is also held at the flat shape at k = 256 and
1024 and on group-2 codes, and ``distance_topk`` at k = 256.

Each top-k time stands beside the product alone through cuBLAS
(``torch.addmm`` over the same B x n_valid x D in f32, TF32 off), and
beside the device time of each kernel the launch ran (``torch.profiler``):
one kernel a call.

With ``--sweep``, phase 4 also times every launch shape of the kernels on
the same inputs (lines ``[4 sweep]``): ``decode_attention`` at each number
of warps sharing a kv head and of splits, each held against its plain
output, beside SDPA, and at the long shape the card's power draw and
clocks under the wrappers' cut and under SDPA; the gather beside one
contiguous copy of the same bytes; ``quant_topk`` and ``distance_topk``
at every cut (tile x chunks) of each of their shapes, each held against
its plain lists, the card's power and clocks under ``quant_topk`` at the
flat shape, and each of the three calls through copies of the kernel with
parts cut out (``TOPK_CUTS``: no candidates; no epilogue; no barrier or
copies) beside an FMA loop from registers.  The wrappers' launch shapes
(``decode_attention.ops.splits`` and ``warps_per_head``,
``quant_topk.ops.launch_shape``) were set from these lines.

Every kernel's launch counter is set to 0 just before each path is
driven and read just after.  The last lines are the kernels' JSON record
(launches summed over the paths that run each kernel), the
``nvidia-smi`` line, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import json
import re
import shutil
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
    dequantize_ref, ids_agree_up_to_ties, quant_topk_ref)
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.quant.codec import quantize_groups  # noqa: E402
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
# phase 11: benchmarks/ingest.py's full run_load geometry (8 chunks)
LOAD = dict(n=20_000, n_rep=64, n_chunks=8, n_queries=500, k=10)
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


def kernel_split(fn, iters: int = 10) -> dict:
    """Device milliseconds of one launch by kernel name (the name up to its
    template arguments), and how many launches of it ``torch.profiler``
    recorded over ``iters`` warmed calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name.removeprefix("void "))[0]
            name = name.split("::")[-1]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.device_time_total / 1e3, n + e.count)
    # a mean over the kernel records the trace holds, which can be fewer
    # than the launches
    return {name: (round(ms / n, 4), f"{n} of {iters} calls")
            for name, (ms, n) in out.items()}


def power_under(fn, ms: float, seconds: float = 3.0) -> dict:
    """The card's power draw and clocks while ``fn`` (``ms`` of device time
    a call) runs back to back for about ``seconds``: ``nvidia-smi``
    samples every 100 ms; the first and last samples are dropped."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw,clocks.sm,clocks.mem",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=60)[0]
    rows = [[float(x) for x in line.split(",")]
            for line in text.splitlines() if line.strip()]
    rows = rows[3:-2] or rows
    med = [sorted(col)[len(col) // 2] for col in zip(*rows)]
    return {"samples": len(rows), "watts_median": med[0],
            "watts_max": max(r[0] for r in rows), "sm_mhz_median": med[1],
            "sm_mhz_min": min(r[1] for r in rows), "mem_mhz_median": med[2]}


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
    launch for all its staged buffers.  Returns (ids per round, fetched
    spans)."""
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
    to batch.  Each fetching round is one gather launch for all the
    quantized buffers (graph blocks, codes, scales).  Returns, per batch,
    (ids per round, fetched spans)."""
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


def gather_launches(exact_gathers, pair_gathers, rag_gathers=(),
                    recorded=()) -> list:
    """Every gather launch of the main path, one per span read, as
    (buffers, ids): phase 5's counted batch in each search mode (graph,
    then scan), then phase 8's counted run in each search mode
    (``pair_gathers``: mode -> the result of ``pair_path_gathers``), then
    phase 9's retrieval (``rag_path_gathers``' result), then the launches
    phases 10 and 11 recorded (``recorded_launches``)."""
    out = [(EXACT_BUFS, ids) for _ in ("graph", "scan")
           for ids in exact_gathers[0]]
    for batches in pair_gathers.values():
        out += [(PAIR_BUFS, ids) for round_ids, _ in batches
                for ids in round_ids]
    out += [(EXACT_BUFS, ids) for round_ids, _ in rag_gathers
            for ids in round_ids]
    return out + list(recorded)


def _gather_record(bufs, launches, device, timed: bool,
                   sweep: bool = False) -> dict:
    """The span gather vs its plain version at every launch of the main
    path (``gather_launches``: one per span read, over all its buffers),
    exactly equal.  The record's work is those launches, in the path's
    order: ``ms``, ``plain_ms`` (``gather_blocks_ref`` per buffer),
    ``library_ms`` (``index_select`` per buffer) and ``bound_ms`` are of
    all of them together.  With ``sweep``, also one contiguous copy of
    the same bytes: the card's copy rate, beside the kernel's."""
    worst = 0.0
    nbytes = 0
    for names in dict.fromkeys(names for names, _ in launches):
        row_bytes = [bufs[n].shape[1] * bufs[n].element_size()
                     for n in names]
        seen = {id(i): i for b, i in launches if b == names}.values()
        for ids in seen:
            got = GO.gather_spans([bufs[n] for n in names], ids)
            for n, g in zip(names, got):
                want = gather_blocks_ref(bufs[n], ids)
                if g.dtype != want.dtype or not torch.equal(g, want):
                    raise AssertionError(f"gather_spans != plain on {n}")
                worst = max(worst,
                            float((g.double() - want.double()).abs().max()))
        rows = [int(ids.shape[0]) for b, ids in launches if b == names]
        part = sum(2 * m * sum(row_bytes) + 4 * m for m in rows)
        nbytes += part
        log(f"[4 kernels] gather_spans {'+'.join(names)} (rows of "
            f"{row_bytes} B), {len(rows)} launches of "
            f"m={sorted(set(rows))} rows: exact match | bound "
            f"{part / PEAK_BYTES_S * 1e3:.4f} ms (bytes)")
    rec = {"name": "gather_blocks", "route": "cuda",
           "source": "src/repro_torch/kernels/gather_blocks/csrc/"
                     "gather_blocks.cu",
           "replaces": "src/repro/kernels/gather_blocks/kernel.py:31",
           "launches": 0, "max_abs_err": worst, "ms": None,
           "plain_ms": None, "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes", "library_ms": None}
    if timed:
        work = [([bufs[n] for n in names], ids) for names, ids in launches]
        outs = [[torch.empty((ids.shape[0], b.shape[1]), dtype=b.dtype,
                             device=device) for b in bs] for bs, ids in work]
        bad = GO.flag(device)

        def kern():
            for (bs, ids), o in zip(work, outs):
                GO._launch(bs, ids, o, bad)

        def plain():
            for bs, ids in work:
                for b in bs:
                    gather_blocks_ref(b, ids)

        def library():
            for bs, ids in work:
                for b in bs:
                    torch.index_select(b, 0, ids)

        rec["ms"] = device_ms(kern, 20)
        rec["plain_ms"] = device_ms(plain, 20)
        rec["library_ms"] = device_ms(library, 20)
        if sweep:
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            copy_ms = device_ms(lambda: dst.copy_(src), 20)
            log(f"[4 sweep] gather_spans: one contiguous copy of the same "
                f"bytes {copy_ms:.4f} ms ({rec['bound_ms'] / copy_ms:.3f} of "
                f"the bound); the kernel {rec['ms']:.4f} ms, "
                f"{copy_ms / rec['ms']:.3f} of the copy's rate")
            del src, dst
        if bad.item():
            raise AssertionError("gather_spans flagged an id out of range")
    log(f"[4 kernels] gather_spans, every span read of phases 5 and 8-11 "
        f"({len(launches)} launches, "
        f"{sum(len(names) for names, _ in launches)} buffer reads): "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"index_select {rec['library_ms']:.4f} ms, " if timed else "")
        + f"bound {rec['bound_ms']:.4f} ms (bytes)")
    return rec


def product_ms(q, x) -> float:
    """The product part alone through cuBLAS: ``torch.addmm`` of q2 - 2 q.x
    over the same B x n_valid x D in f32 (TF32 off).  A yardstick for the
    top-k kernels' product; no single torch call computes distance plus
    top-k, and the port never calls this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q2 = (q * q).sum(-1, keepdim=True)
    xt = x.T
    return device_ms(lambda: torch.addmm(q2, q, xt, alpha=-2.0), 20)


def _topk_sweep(name: str, label: str, launch, want, B: int, nv: int,
                kk: int, quant: bool, bound_ms: float,
                power: bool = False) -> None:
    """``--sweep``: one top-k kernel at every cut (tile x chunks) of one
    shape, each held against the plain lists ``want`` as ``_topk_check``
    holds it, beside the bound; ``launch(bufs, tile, S)`` launches once.
    With ``power``, the card's draw and clocks under the wrappers' cut."""
    default = QO.launch_shape(B, nv, kk, quant)
    for tile in QO.TILES:
        if not QO.ctas_per_sm(tile, kk, quant):
            continue
        n_tiles = max(-(-nv // tile), 1)
        cuts = sorted({-(-n_tiles // -(-n_tiles // n)) for n in
                       (1, 2, 4, 8, 16, 24, 33, 48, 66, 99, 132, 264)
                       if n <= n_tiles} | ({default[1]} if tile == default[0]
                                           else set()))
        for S in cuts:
            bufs = QO.buffers(B, kk, S, want[0].device)
            launch(bufs, tile, S)
            _topk_check(f"{name} {label} tile={tile} S={S}", bufs[2],
                        bufs[3], *want, kk)
            ms = device_ms(lambda: launch(bufs, tile, S), 10)
            mark = " (the wrappers' cut)" if (tile, S) == default else ""
            log(f"[4 sweep] {name} {label}: tile {tile}, {S} chunks of "
                f"{-(-n_tiles // S)} tiles: {ms:.4f} ms, {bound_ms / ms:.3f} "
                f"of the bound{mark}")
    if power:
        bufs = QO.buffers(B, kk, default[1], want[0].device)
        fn = lambda: launch(bufs, *default)  # noqa: E731
        ms = device_ms(fn, 10)
        log(f"[4 sweep] power under {name} at the {label} shape "
            f"({ms:.4f} ms a call): {json.dumps(power_under(fn, ms))}")


# ``--sweep``: copies of kernels/csrc/topk_tile.cuh with parts cut out,
# each keeping every FMA of the product alive (only "full" is right)
_NONE_PASS = ("if (q0 + i < B && n0 + j < row_end)\n          pending",
              "if (q0 + i < B && n0 + j < row_end && acc[r][c] < -1e30f)\n"
              "          pending")
_NO_EPILOGUE = ("    if (sl != n_slices - 1) continue;",
                "    {\n      float sum = 0.f;\n#pragma unroll\n"
                "      for (int r = 0; r < TM; ++r)\n#pragma unroll\n"
                "        for (int c = 0; c < TN; ++c) sum += acc[r][c];\n"
                "      if (sl != n_slices - 1 || sum != -12345.f) continue;\n"
                "    }")
_NO_BARRIER = ("    __syncthreads();   // slice t landed",
               "    // slice t landed")
_NO_COPIES = ("  auto issue = [&](int t) {\n",
              "  auto issue = [&](int t) {\n"
              "    if (t >= 2 * n_slices) { cp_commit(); return; }\n")
TOPK_CUTS = {
    "full": [],                   # as it ships
    "product": [_NONE_PASS],      # no candidates: product, copies, epilogue
    "no_epilogue": [_NONE_PASS, _NO_EPILOGUE],   # product, copies, barriers
    "bare": [_NONE_PASS, _NO_EPILOGUE, _NO_BARRIER, _NO_COPIES]}
FMA_LOOP = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) fma_loop(float* out, int iters) {
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = fmaf(acc[i], 0.999f, 1e-3f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int fma_launch(void* out, int blocks, int iters) {
  fma_loop<<<blocks, 256>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def topk_cut(cut: str) -> str:
    """kernels/csrc/topk_tile.cuh with ``cut``'s parts taken out."""
    text = (_build.KERNELS_DIR / "csrc" / "topk_tile.cuh").read_text()
    for old, new in TOPK_CUTS[cut]:
        if old not in text:
            raise RuntimeError(f"topk cut {cut}: the kernel no longer has "
                               f"{old!r}")
        text = text.replace(old, new)
    return text


def _build_cuts() -> dict:
    """One kernel library per cut, and the FMA loop's, under
    build/topk_cuts/ (one nvcc each, all started together)."""
    out = ROOT / "build" / "topk_cuts"
    jobs = {}
    for cut in TOPK_CUTS:
        root = out / cut
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.KERNELS_DIR, root,
                        ignore=shutil.ignore_patterns("__pycache__", "*.py"))
        (root / "csrc" / "topk_tile.cuh").write_text(topk_cut(cut))
        jobs[cut] = sorted(map(str, root.glob("*/csrc/*.cu")))
    (out / "fma.cu").write_text(FMA_LOOP)
    jobs["fma"] = [str(out / "fma.cu")]
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(out / f"{name}.so"), *srcs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, srcs in jobs.items()}
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} cut:\n{text}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        sigs = ({"fma_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]}
                if name == "fma" else _build.SIGNATURES)
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def topk_anatomy(calls, device) -> None:
    """``--sweep``: each top-k call of ``calls`` ((label, launch(bufs, tile,
    S), B, n_valid, k, quant, GFLOP)) at the wrappers' cut through every
    cut of the kernel, and the FMA rate of a loop from registers."""
    libs = _build_cuts()
    shipped = _build.library()
    try:
        for cut in TOPK_CUTS:
            _build._lib = libs[cut]
            for label, launch, B, nv, k, quant, gflop in calls:
                tile, S = QO.launch_shape(B, nv, k, quant)
                bufs = QO.buffers(B, k, S, device)
                ms = device_ms(lambda: launch(bufs, tile, S), 20)
                log(f"[4 sweep] top-k cut {cut}, {label}: {ms:.4f} ms "
                    f"({gflop / ms:.1f} TFLOP/s of the product)")
    finally:
        _build._lib = shipped
    out = torch.empty(132 * 4 * 256, device=device)
    fma, iters = libs["fma"], 4000
    ms = device_ms(lambda: _build.check(
        fma.fma_launch(out.data_ptr(), 132 * 4, iters), "fma_loop"), 5)
    log(f"[4 sweep] FMA loop from registers (528 CTAs of 256 threads, 64 "
        f"accumulators): {2.0 * out.numel() * iters * 64 / ms / 1e9:.1f} "
        f"TFLOP/s")


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


def _distance_record(shapes, device, timed: bool, sweep: bool = False,
                     calls=None) -> dict:
    """distance_topk against its plain version at each of ``shapes``
    ((label, q, x, n_valid, k), the first one the throughput path's), in
    f32 and on bf16 inputs (against the plain version on the same
    f32-cast inputs), timed beside the cuBLAS product alone.  The record's
    numbers are the first shape's.  ``sweep``: ``_topk_sweep`` at each
    shape; ``calls`` collects each timed call for ``topk_anatomy``."""
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
        ms = plain_ms = gemm_ms = None
        if timed and kk > QO.K_MAX:     # the large-k route: two kernels
            ms = device_ms(lambda: DO.distance_topk(q, x, kk, n_valid=nv),
                           10)
            plain_ms = device_ms(lambda: distance_topk_ref(q, x, kk, nv), 3)
            gemm_ms = product_ms(q, x[:nv])
            split = kernel_split(lambda: DO.distance_topk(q, x, kk,
                                                          n_valid=nv))
            log(f"[4 kernels] distance_topk {label}: the large-k route; "
                f"device time by kernel {split}")
        elif timed:
            tile, S = QO.launch_shape(B, nv, kk, quant=False)
            bufs = QO.buffers(B, kk, S, device)

            def launch(bufs, tile, S, q=q, x=x, nv=nv, kk=kk):
                DO._launch(q, x, kk, nv, bufs, tile, S)
            ms = device_ms(lambda: launch(bufs, tile, S), 20)
            plain_ms = device_ms(lambda: distance_topk_ref(q, x, kk, nv), 5)
            gemm_ms = product_ms(q, x[:nv])
            log(f"[4 kernels] distance_topk {label}: tile {tile}, {S} "
                f"chunks; device time by kernel "
                f"{kernel_split(lambda: launch(bufs, tile, S))}")
            if calls is not None:
                calls.append((f"distance_topk {label}", launch, B, nv, kk,
                              False, flops / 1e9))
            if sweep:
                want = distance_topk_ref(q, x, min(kk + 1, N), nv)
                _topk_sweep("distance_topk", label, launch, want, B, nv, kk,
                            False, bound_ms)
        rec["max_abs_err"] = max(rec["max_abs_err"], err, err_b)
        if j == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[4 kernels] distance_topk {label} B={B} N={N} n_valid={nv} "
            f"D={D} k={kk}: ids equal up to ties ({n_diff} tied positions "
            f"differ; bf16 inputs {n_diff_b}), max |d - plain| "
            f"{max(err, err_b):.3g} | "
            + (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
               f"product alone {gemm_ms:.4f} ms, " if timed else "")
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


def _decode_sweep(label: str, sets, want, bound_ms: float, sdpa,
                  sdpa_ms, power: bool) -> None:
    """``--sweep``: decode_attention at every cut of one shape's caches
    (warps sharing a kv head x splits) over the timed copies ``sets``,
    each held against the plain output ``want`` as ``_decode_checks``
    holds it, beside SDPA (``sdpa``, ``sdpa_ms``: the same copies) and
    the bound.  With ``power``, the card's draw and clocks under the
    wrappers' cut and under SDPA."""
    q, k = sets[0][0], sets[0][1]
    B, S, K = q.shape[0], k.shape[1], k.shape[2]
    lim = BF16_STEPS * float(want.abs().max())
    default = (DA.warps_per_head(B, K), DA.splits(B, K, S))
    tiles = -(-S // 64)
    cuts = dict.fromkeys(
        (n_split, split_len) for n in (1, 2, 3, 4, 6, 8, 12, 17, 33, 64)
        if n <= tiles for split_len in [-(-tiles // n) * 64]
        for n_split in [-(-S // split_len)])
    for wph in (1, 2, 4, 8):
        for n_split, split_len in cuts:
            bufs = [DA.buffers(a[0], a[1], n_split, split_len) for a in sets]
            DA._launch(*sets[0], *bufs[0], DA.WARPS, wph)
            got = bufs[0][2].float()
            err = float((got - want).abs().max())
            if (err > lim if q.dtype == torch.bfloat16
                    else not torch.allclose(got, want, **F32_TOL)):
                raise AssertionError(
                    f"decode_attention {label} wph={wph} n_split={n_split}:"
                    f" max |out - plain| {err:.3g} > {lim:.3g}")
            ms = device_ms(lambda: [DA._launch(*a, *b, DA.WARPS, wph)
                                    for a, b in zip(sets, bufs)],
                           20) / len(sets)
            mark = (" (the wrappers' cut)"
                    if (wph, (n_split, split_len)) == default else "")
            log(f"[4 sweep] decode_attention {label}: {wph} warps a kv "
                f"head, {n_split} splits of {split_len} keys: {ms:.4f} ms, "
                + (f"{ms / sdpa_ms:.3f} x SDPA, " if sdpa_ms else "")
                + f"{bound_ms / ms:.3f} of the bound{mark}")
    if power:
        bufs = [DA.buffers(a[0], a[1]) for a in sets]
        runs = {"decode_attention": lambda: [DA._launch(*a, *b) for a, b
                                             in zip(sets, bufs)]}
        if sdpa_ms:
            runs["SDPA"] = sdpa
        for name, fn in runs.items():
            ms = device_ms(fn, 20)
            log(f"[4 sweep] power under {name} at the {label} shape "
                f"({ms:.4f} ms a call): {json.dumps(power_under(fn, ms))}")


def _decode_record(shapes, device, timed: bool, sweep: bool = False) -> dict:
    """decode_attention against its plain version at each of ``shapes``
    ((label, q, k, v, pos), the first one the decode path's), as
    ``_decode_checks`` holds it; at the path's shape also against
    ``attend_decode`` at pos - 1.  Timed over copies that together
    exceed the 50 MB L2 (the path finds each layer's cache cold: the
    whole model's weights stream between two calls on one layer).  The
    record's numbers are the first shape's.  ``sweep``: see
    ``_decode_sweep`` (power at the last shape)."""
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
            if sweep:
                _decode_sweep(label, sets, want, bound_ms,
                              lambda: [_sdpa(*a) for a in lib], lib_ms,
                              power=j == len(shapes) - 1)
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


def wide_topk(q, codes, scales, vecs, n_valid: int, group: int,
              timed: bool) -> None:
    """``quant_topk`` at the flat shape past the path's k: at k = 256 and
    1024 (the large-k route: the product into a distance matrix, then the
    per-query select) and, at the path's k = 20, on group-2 codes of the
    same rows quantized on the host by ``quant.codec.quantize_groups``
    (the per-code scale path).  Each held against its plain version as
    the path's call is, timed beside it and its bound."""
    B, D = q.shape
    c2, s2 = quantize_groups(vecs.cpu().numpy(), 2)
    c2 = torch.as_tensor(c2, device=q.device)
    s2 = torch.as_tensor(s2, device=q.device)
    for label, c, s, g, k in (("k=256", codes, scales, group, 256),
                              ("k=1024", codes, scales, group, 1024),
                              ("group 2", c2, s2, 2, 20)):
        kk = min(k, n_valid)
        err, n_diff = _topk_check(
            f"quant_topk {label}", *QO.quant_topk(q, c, s, kk, g,
                                                  n_valid=n_valid),
            *quant_topk_ref(q, c, s, min(kk + 1, c.shape[0]), g, n_valid),
            kk)
        flops = 2.0 * B * n_valid * D
        nbytes = (B * D * 4 + n_valid * D + n_valid * (D // g) * 4
                  + B * kk * 8)
        bound = max(flops / PEAK_F32_FLOPS_S, nbytes / PEAK_BYTES_S) * 1e3
        line = ""
        if timed:
            def fn(c=c, s=s, g=g, kk=kk):
                return QO.quant_topk(q, c, s, kk, g, n_valid=n_valid)
            ms = device_ms(fn, 10)
            plain_ms = device_ms(lambda: quant_topk_ref(
                q, c, s, kk, g, n_valid), 3)
            line = (f"kernel {ms:.4f} ms ({bound / ms:.3f} of the bound), "
                    f"plain {plain_ms:.4f} ms, device time by kernel "
                    f"{kernel_split(fn)}, ")
        route = "the large-k route" if kk > QO.K_MAX else "one launch"
        log(f"[4 kernels] quant_topk {label} B={B} n_valid={n_valid} D={D} "
            f"group={g} k={kk} ({route}): "
            f"ids equal up to ties ({n_diff} tied positions differ), max "
            f"|d - plain| {err:.3g} | {line}bound {bound:.4f} ms")


def phase_kernels(store, qstore, data, queries, launches, device, *,
                  k: int = 20, decode_shapes=(), sweep: bool = False,
                  extra_bufs=None) -> list:
    """Phase 4: each kernel against its plain version at the paths'
    shapes.  gather_blocks: every launch of phases 5, 8 and 9
    (``gather_launches``: one per span read) on its staged buffers (int32
    graph blocks, f32 vector blocks, int8 codes, f32 scales), exactly
    equal.  quant_topk:
    the flat stage-1 call (all queries against the padded flat int8
    database).  distance_topk: the throughput benchmark's call
    (``queries[:128]`` x ``data[:4096]``, k=10) and the flat f32 twin of
    the quant_topk call.  Top-k ids equal up to ties and distances within
    rtol 1e-5 / atol 1e-3.  decode_attention: ``decode_shapes`` (see
    ``_decode_record``), when given.  ``extra_bufs`` names the buffers
    of the launches phases 10 and 11 recorded.  Beside the path's calls,
    ``quant_topk`` is held at the flat shape at k = 256 and 1024 (the
    large-k route) and on group-2 codes of the same rows (the per-code
    scale path), and ``distance_topk`` at k = 256 (``wide_topk``).  Times
    only on the card; ``sweep`` adds the ``--sweep`` lines."""
    timed = device.type == "cuda"
    bufs = {"graph": torch.as_tensor(store.graph_buf, device=device),
            "vec": torch.as_tensor(store.vec_buf, device=device),
            "codes": torch.as_tensor(qstore.qvec_buf, device=device),
            "scales": torch.as_tensor(qstore.qscale_buf, device=device),
            **(extra_bufs or {})}
    records = [_gather_record(bufs, launches, device, timed, sweep)]

    calls = []           # the timed top-k calls, for ``topk_anatomy``
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
        tile, S = QO.launch_shape(B, n_valid, kk, quant=True)
        bufs_q = QO.buffers(B, kk, S, device)

        def launch(bufs, tile, S):
            QO._launch(q, codes, scales, kk, group, n_valid, bufs, tile, S)
        rec["ms"] = device_ms(lambda: launch(bufs_q, tile, S), 20)
        rec["plain_ms"] = device_ms(lambda: quant_topk_ref(
            q, codes, scales, kk, group, n_valid), 5)
        gemm_ms = product_ms(q, dequantize_ref(codes[:n_valid],
                                               scales[:n_valid], group))
        log(f"[4 kernels] quant_topk: tile {tile}, {S} chunks; device time "
            f"by kernel {kernel_split(lambda: launch(bufs_q, tile, S))}")
        calls.append(("quant_topk flat", launch, B, n_valid, kk, True,
                      flops / 1e9))
        if sweep:
            _topk_sweep("quant_topk", "flat", launch, quant_topk_ref(
                q, codes, scales, kk + 1, group, n_valid), B, n_valid, kk,
                True, rec["bound_ms"], power=True)
    records.append(rec)
    log(f"[4 kernels] quant_topk B={B} N={codes.shape[0]} n_valid={n_valid}"
        f" D={D} group={group} k={kk}: ids equal up to ties ({n_diff} tied"
        f" positions differ), max |d - plain| {q_err:.3g} | "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"cuBLAS product alone {gemm_ms:.4f} ms, " if timed else "")
        + f"library none, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}, {flops / 1e9:.1f} GFLOP)")
    wide_topk(q, codes, scales, vecs, n_valid, group, timed)
    x_small = torch.as_tensor(data[:4096], device=device)
    records.append(_distance_record(
        [("throughput", q[:128], x_small, x_small.shape[0], 10),
         ("flat f32", q, vecs, n_valid, k),
         ("flat f32 k=256", q, vecs, n_valid, 256)], device, timed, sweep,
        calls))
    if sweep and timed:
        topk_anatomy(calls, device)
    if decode_shapes:
        records.append(_decode_record(decode_shapes, device, timed, sweep))
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
    round (span read), so phase 4 timed the launches made here.
    Returns the gather launches of the path and the scan batch's stats
    (its recall@k under ``recall_at_k``)."""
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
        want = len(round_ids) if device.type == "cuda" else 0
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
    st["recall_at_k"] = rec          # the scan batch's, phase 10's floor
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
    round (span read), so phase 4 checked and timed the launches made
    here.  Returns the gather launches of the path."""
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
            want = len(round_ids) if device.type == "cuda" else 0
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
        name = "decode_attention" if "decode_attention" in name else name[:48]
        acc = by.setdefault(name, [0.0, 0])
        acc[0] += t - s
        acc[1] += 1
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:6]
    att_us, att_n = by.get("decode_attention", [0.0, 0])
    log(f"{head} | {len(kern)} device events | device busy "
        f"{busy / 1e3:.3f} ms ({busy / n_steps / 1e3:.3f} ms a step): busy "
        f"share {busy / wall_us:.4f} of the profiled window (idle "
        f"{1 - busy / wall_us:.4f}), {busy / (decode_s * 1e6):.4f} of the "
        f"unprofiled call's decode time (idle "
        f"{1 - busy / (decode_s * 1e6):.4f}) | decode_attention "
        f"{att_us / 1e3:.3f} ms in {att_n} launches, {att_us / max(att_n, 1):.2f} us each "
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
        want_gather = len(round_ids) if on_card else 0
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
    round.  Then ``profile_serve`` measures the
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


# ------------------------------------------------------ insert and load

class CallLog:
    """While active, records every call of ``module.name`` (its buffers
    and a clone of its block ids: ``gather_spans(bufs, ids)``); each call
    still goes through to the real function, so its launches count."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self) -> "CallLog":
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, bufs, ids):
        self.calls.append((tuple(bufs), ids.clone()))
        return self.real(bufs, ids)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.real)


def recorded_launches(calls, bufs: dict, tag: str) -> list:
    """Recorded ``gather_spans`` calls as ``gather_launches`` entries: each
    staged buffer gets a name in ``bufs`` (``tag`` and a serial number,
    one per distinct tensor), so phase 4 holds and times the launches on
    the very tensors they read."""
    names = {}
    for b, _ in calls:
        for t in b:
            if id(t) not in names:
                names[id(t)] = f"{tag}{len(names)}"
                bufs[names[id(t)]] = t
    return [(tuple(names[id(t)] for t in b), ids) for b, ids in calls]


class InsertClock:
    """Host seconds of the insert path's parts while active, each device
    part ended by a sync: ``route`` (the meta-HNSW routing), ``host``
    (the host region's writes: ``layout.insert_vector`` and the int8
    mirror's re-quantize), ``device`` (the device twin's scatters) and
    ``repack`` (the whole repack verb, its re-stage included; the parts
    inside it are not counted again)."""

    PARTS = ("route", "host", "device", "repack")

    def __init__(self, eng):
        self.eng = eng
        self.sec = dict.fromkeys(self.PARTS, 0.0)
        self._in_repack = False
        self._undo = []

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap(self, owner, name: str, part: str, instance: bool) -> None:
        real = getattr(owner, name)

        def timed(*a, **kw):
            if self._in_repack:
                return real(*a, **kw)
            self._in_repack = part == "repack"
            t0 = time.perf_counter()
            try:
                out = real(*a, **kw)
                self._sync()
            finally:
                self._in_repack = False
            self.sec[part] += time.perf_counter() - t0
            return out
        setattr(owner, name, timed)
        self._undo.append((owner, name, real, instance))

    def __enter__(self) -> "InsertClock":
        c = self.eng.client
        for owner, name, part, inst in (
                (c, "_route", "route", True),
                (LA, "insert_vector", "host", False),
                (LA, "refresh_quant_blocks", "host", False),
                (DS, "overflow_append", "device", False),
                (DS, "overflow_append_quant", "device", False),
                (c.pool, "repack", "repack", True)):
            self._wrap(owner, name, part, inst)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, real, inst in reversed(self._undo):
            if inst:
                delattr(owner, name)
            else:
                setattr(owner, name, real)
        self._undo = []


def _timed_insert(eng, vecs) -> tuple:
    """``eng.insert(vecs)`` under an ``InsertClock``: (gids, wall s, the
    clock's parts)."""
    on_card = eng.device.type == "cuda"
    with InsertClock(eng) as clock:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        gids = eng.insert(vecs)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return gids, wall, clock.sec


def _region_equal(pool, what: str) -> None:
    """The pool's device region, copied back to the host, equals the host
    region bit for bit: graph and vector blocks, the int8 codes and
    scales when attached, and the meta table (``read_meta``)."""
    st = pool.store
    pairs = [("graph", pool._g_dev, st.graph_buf),
             ("vec", pool._v_dev, st.vec_buf),
             ("meta", pool.read_meta(), st.meta_table)]
    if pool._qv_dev is not None:
        pairs += [("codes", pool._qv_dev, st.qvec_buf),
                  ("scales", pool._qs_dev, st.qscale_buf)]
    for name, dev, host in pairs:
        got = dev.cpu().numpy()
        if (got.dtype != host.dtype or got.shape != host.shape
                or got.tobytes() != np.ascontiguousarray(host).tobytes()):
            raise AssertionError(f"{what}: the device {name} region differs "
                                 f"from the host's")


def _flat_equal_to_sync(client, what: str) -> int:
    """The int8 flat view grown by inserts (codes, scales and the payload
    twin, row for row by region row) equals a fresh ``_sync_flat`` of the
    same store.  Returns the view's rows."""
    from repro_torch.core.cost_model import NetLedger
    n = client._flat_n
    grown = [t[:n].cpu() for t in (client._flat_codes, client._flat_scales,
                                   client._flat_cols)]
    rows = client._flat_idx[:n].copy()
    client._sync_flat(NetLedger(client.cfg.fabric))
    if client._flat_n != n:
        raise AssertionError(f"{what}: flat view of {n} rows, a fresh sync "
                             f"has {client._flat_n}")
    at = {int(r): j for j, r in enumerate(client._flat_idx[:n])}
    if len(at) != n or set(at) != {int(r) for r in rows}:
        raise AssertionError(f"{what}: the flat view's rows differ from a "
                             f"fresh sync's")
    perm = torch.as_tensor([at[int(r)] for r in rows])
    fresh = (client._flat_codes, client._flat_scales, client._flat_cols)
    for name, old, new in zip(("codes", "scales", "cols"), grown, fresh):
        if not torch.equal(old, new[:n].cpu()[perm]):
            raise AssertionError(f"{what}: flat {name} differ from a fresh "
                                 f"sync")
    return n


def brute_force_gt(data: np.ndarray, queries: np.ndarray, k: int,
                   device) -> np.ndarray:
    """Exact top-k ids of ``queries`` over ``data`` (squared L2 in f32,
    TF32 off), computed on ``device`` in blocks of queries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.as_tensor(data, device=device)
    x2 = (x * x).sum(-1)
    out = []
    for s in range(0, len(queries), 256):
        q = torch.as_tensor(queries[s:s + 256], device=device)
        d = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ x.T) + x2[None]
        out.append(torch.topk(d, k, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def burst_target(eng, data: np.ndarray, n_burst: int) -> int:
    """A base row whose partition a burst of ``n_burst`` near copies can
    overflow and repack without a full rebuild: both partitions of its
    group (the one ``data[t]`` routes to and its partner) hold at most
    ``np_max - n_burst`` rows, overflow included.  The first such row in
    row order."""
    store, spec = eng.store, eng.store.spec
    mt = store.meta_table
    ov = mt[:, LA.MT_OV_A] + mt[:, LA.MT_OV_B]
    size = np.asarray(store.n_base) + ov
    fits = np.zeros(spec.n_partitions, bool)
    for p in range(spec.n_partitions):
        g = int(mt[p, LA.MT_GROUP])
        fits[p] = all(size[q] + n_burst <= spec.np_max
                      for q in (2 * g, 2 * g + 1) if q < spec.n_partitions)
    cand = np.nonzero(fits[eng.meta.assignments])[0]
    for t in cand[:64]:
        pid = int(eng.client._route(eng.client._t(data[t:t + 1]), b=1)[0, 0])
        if fits[pid]:
            return int(t)
    raise AssertionError("no partition can take the burst without a full "
                         "rebuild")


def _self_recall(eng, vecs, gids, k: int = 10) -> float:
    """Share of ``vecs`` whose nearest result is their own gid."""
    _, g, _ = eng.search(vecs, k=k)
    return float(np.mean(g[:, 0] == np.asarray(gids)))


def _insert_line(label: str, n: int, wall: float, sec: dict) -> str:
    other = wall - sum(sec.values())
    return (f"{label}: {n} inserts in {wall:.4f} s, "
            f"{wall / n * 1e6:.1f} us an insert = route "
            f"{sec['route'] / n * 1e6:.1f} + host write "
            f"{sec['host'] / n * 1e6:.1f} + device twin "
            f"{sec['device'] / n * 1e6:.1f} + repack "
            f"{sec['repack'] / n * 1e6:.1f} + other {other / n * 1e6:.1f} us"
            f" (repack {sec['repack']:.4f} s)")


def phase_insert(ds, meta, store, qstore, device, *, k: int, doorbell: int,
                 scan_recall: float, n_held: int = 256, burst_extra: int = 8,
                 seed: int = 1) -> tuple:
    """Phase 10: insert at full size, on deep copies of phase 3's store
    and qstore (no other phase sees a mutation).  The exact-scan engine
    of phase 5 (the CUDA gather on) and the int8 flat engine of phase 6
    (its flat view synced first) each insert ``queries[:n_held]``, then a
    burst of ``ov_cap + burst_extra`` near copies of one base row
    (``data[t] + 0.0005 N(0, 1)``, ``burst_target``: its group repacks
    without a full rebuild).  A ``device="cpu"`` port engine runs the
    same inserts on a third copy: the routed partitions must agree up to
    ties in the meta distances.  Checks: gids, verb counts, the insert
    ledger against the charge rule, the device region against the host
    region after the inserts and after the repack, the flat view against
    a fresh sync, self-recall@1 in scan mode, recall@10 over all queries
    against brute force over the grown data, and an int8 search with
    ``rerank_m=256`` (the large-k route of ``quant_topk``).  Returns
    (launches of the post-insert searches, the gather launches they made
    as ``gather_launches`` entries, their buffers)."""
    n0, dim = ds.data.shape
    held = np.ascontiguousarray(ds.queries[:n_held])
    on_card = device.type == "cuda"
    spec = store.spec
    rng = np.random.default_rng(seed)

    def exact_engine(dev):
        return DHNSWEngine(exact_config(meta.n_partitions, doorbell, "scan"),
                           device=dev).adopt_built(
            meta, copy.deepcopy(store), ds.data)
    eng = exact_engine(device)
    qcfg = EngineConfig(mode="full", search_mode="scan", b=6,
                        n_rep=meta.n_partitions, quant="int8",
                        quant_kernel="auto", cache_frac=0.6, exact_frac=0.25,
                        doorbell=doorbell, fabric=RDMA_100G)
    q8 = DHNSWEngine(qcfg, device=device).adopt_built(
        meta, copy.deepcopy(qstore), ds.data)
    twin = exact_engine(torch.device("cpu"))
    q8.search(ds.queries[:8], k=k)              # the flat view, synced
    wire = {"exact": dim * 4 + 8, "cpu": dim * 4 + 8,
            "int8": dim * 4 + 8 + dim + dim // qstore.spec.quant_group * 4}
    engines = (("exact", eng), ("int8", q8), ("cpu", twin))
    launches = {name: 0 for name in KERNEL_OPS}
    n_burst = spec.ov_cap + burst_extra
    burst = None
    for label in ("held-out", "burst"):
        if label == "burst":     # the target, after the held-out inserts
            t = burst_target(eng, ds.data, n_burst)
            burst = (ds.data[t][None] + 0.0005 * rng.standard_normal(
                (n_burst, dim))).astype(np.float32)
        vecs = held if label == "held-out" else burst
        for name, e in engines:
            n_pre = e.client._n0 + len(e.client._extra)
            totals = dict(e.pool.totals)
            verbs = dict(e.pool.verbs)
            gids, wall, sec = _timed_insert(e, vecs)
            if not np.array_equal(gids, np.arange(n_pre, n_pre + len(vecs))):
                raise AssertionError(f"insert {name} {label}: gids {gids[:3]}"
                                     f"... not from {n_pre}")
            repacks = e.pool.verbs["repack"] - verbs.get("repack", 0)
            # the append that finds the region full lands nothing and is
            # not counted; its row is appended again after the repack
            n_app = len(vecs)
            if e.pool.verbs["append"] - verbs.get("append", 0) != n_app:
                raise AssertionError(f"insert {name} {label}: "
                                     f"{dict(e.pool.verbs)}, want {n_app} "
                                     f"more appends")
            if label == "burst" and repacks < 1:
                raise AssertionError(f"insert {name}: the burst repacked "
                                     f"nothing")
            per = wire[name]
            want = {"round_trips": n_app, "descriptors": n_app,
                    "bytes": n_app * per}
            moved = {key: e.pool.totals[key] - totals[key] for key in totals}
            net = {key: e._last_insert_net[key] for key in want}
            if moved != want or net != want:
                raise AssertionError(f"insert {name} {label}: ledger {net}, "
                                     f"pool totals moved {moved}, want "
                                     f"{n_app} writes of {per} B")
            if name != "cpu":
                _region_equal(e.pool, f"insert {name} {label}")
            what = _insert_line(f"{name} {label}", len(vecs), wall, sec)
            log(f"[10 insert] {what} | {n_app} appends, {repacks} repacks, "
                f"{n_app} writes of "
                f"{per} B charged"
                + (" | device region equal to the host's" if name != "cpu"
                   else ""))
            if name == "int8" and label == "held-out":
                n_flat = _flat_equal_to_sync(e.client, "insert int8")
                log(f"[10 insert] int8 flat view after {len(vecs)} inserts: "
                    f"{n_flat} rows equal to a fresh sync (codes, scales, "
                    f"payload twin)")

    # routing against the CPU twin: equal up to ties in meta distances
    reps = meta.graph.vectors
    diff = [g for g, p in eng.client._extra_pid.items()
            if twin.client._extra_pid[g] != p]
    for g in diff:
        v = eng.client._extra[g]
        d = [float(((v - reps[p]) ** 2).sum()) for p in
             (eng.client._extra_pid[g], twin.client._extra_pid[g])]
        if abs(d[0] - d[1]) > 1e-5 * max(d):
            raise AssertionError(f"insert: gid {g} routed to {d} on the card "
                                 f"and the CPU beyond a tie")
    log(f"[10 insert] routed partitions equal to the CPU engine's for "
        f"{len(eng.client._extra_pid) - len(diff)} of "
        f"{len(eng.client._extra_pid)} rows ({len(diff)} at ties)")

    # searches after the inserts: the gather launches are recorded
    grown = np.concatenate([ds.data, held, burst])
    gt = brute_force_gt(grown, ds.queries, k, device)
    bufs = {}

    def timed(e, vecs):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = e.search(vecs, k=k)
        if on_card:
            torch.cuda.synchronize()
        return (*out, time.perf_counter() - t0)

    with CallLog(GO, "gather_spans") as calls:
        _reset_launches()
        self_q = _self_recall(eng, held[:64], n0 + np.arange(len(held[:64])))
        self_b = _self_recall(eng, burst[:32],
                              np.arange(n0 + n_held, n0 + n_held + 32))
        d, g, st, wall = timed(eng, ds.queries)
        n_exact = _launches()
    recorded = recorded_launches(calls.calls, bufs, "insert.")
    if on_card and n_exact["gather_blocks"] != len(calls.calls):
        raise AssertionError("insert: gather launches and recorded calls "
                             "differ")
    _check_output(d, g, len(ds.queries), k, len(grown), "insert exact")
    rec = recall_at_k(g, gt)
    if self_q != 1.0 or self_b != 1.0:
        raise AssertionError(f"insert exact: self-recall@1 {self_q} "
                             f"(held-out) / {self_b} (burst), want 1.0")
    if rec < scan_recall - 0.01:
        raise AssertionError(f"insert exact: recall@{k} {rec} below phase "
                             f"5's {scan_recall} - 0.01")
    log(f"[10 insert] exact scan after the inserts: self-recall@1 "
        f"{self_q:.4f} (held-out[:64]) {self_b:.4f} (burst[:32]) | "
        f"recall@{k} {rec:.4f} vs brute force over {len(grown)} rows "
        f"(phase 5 scan {scan_recall:.4f}) | search wall {wall:.4f} s | "
        f"{_counted(st)} | gather launches {n_exact['gather_blocks']} "
        f"(3 searches)")

    _reset_launches()
    s8_q = _self_recall(q8, held[:64], n0 + np.arange(len(held[:64])))
    s8_b = _self_recall(q8, burst[:32],
                        np.arange(n0 + n_held, n0 + n_held + 32))
    d8, g8, st8, wall8 = timed(q8, ds.queries)
    n8 = _launches()
    q8.client.cfg = dataclasses.replace(qcfg, rerank_m=256)
    try:
        d9, g9, st9, wall9 = timed(q8, ds.queries)
    finally:
        q8.client.cfg = qcfg
    n9 = {key: v - n8[key] for key, v in _launches().items()}
    for key in launches:
        launches[key] += n_exact[key] + n8[key] + n9[key]
    want = "cuda" if on_card else "ref"
    if st8["stage1_impl"] != want or st9["stage1_impl"] != want:
        raise AssertionError(f"insert int8: stage 1 {st8['stage1_impl']} / "
                             f"{st9['stage1_impl']}")
    if on_card and (n9["quant_topk"] != 2 or st9["rerank_m"] != 256):
        raise AssertionError(f"insert int8: rerank_m=256 made "
                             f"{n9['quant_topk']} quant_topk launches, want "
                             f"the large-k route's 2")
    if s8_q != 1.0:
        raise AssertionError(f"insert int8: self-recall@1 {s8_q} of the "
                             f"held-out rows, want 1.0")
    _check_output(d8, g8, len(ds.queries), k, len(grown), "insert int8")
    _check_output(d9, g9, len(ds.queries), k, len(grown), "insert int8 m256")
    r8, r9 = recall_at_k(g8, gt), recall_at_k(g9, gt)
    if r9 < r8:
        raise AssertionError(f"insert int8: recall@{k} {r9} at rerank_m=256"
                             f" below {r8} at m={st8['rerank_m']}")
    log(f"[10 insert] int8 flat after the inserts: self-recall@1 "
        f"{s8_q:.4f} (held-out[:64]) {s8_b:.4f} (burst[:32], reported) | "
        f"recall@{k} {r8:.4f} at m={st8['rerank_m']} (wall {wall8:.4f} s), "
        f"{r9:.4f} at m=256 (wall {wall9:.4f} s, quant_topk launches "
        f"{n9['quant_topk']}: the large-k route) | flat_rows "
        f"{st8['flat_rows']} | launches {launches}")
    del eng, q8, twin
    if on_card:
        torch.cuda.empty_cache()
    return launches, recorded, bufs


def phase_load(device, *, n: int, n_rep: int, n_chunks: int,
               n_queries: int, k: int, doorbell: int,
               seed: int = SEED) -> tuple:
    """Phase 11: ``DHNSWEngine.build_streaming`` at ``benchmarks/
    ingest.py``'s full ``run_load`` geometry, and ``build`` of the same
    data, both serving on ``device`` (the exact-scan config, the CUDA
    gather on): meta, host and device regions, and a search of
    ``n_queries`` (gids and distances) must be bit-identical; the
    ``LoadReport`` counts ``n_chunks`` chunks, none failed, and a peak
    builder memory under half the dataset.  Returns (launches, the
    searches' gather launches as ``gather_launches`` entries, their
    buffers)."""
    from repro_torch.ingest import chunked_source
    ds = sift_like(n=n, n_queries=n_queries, seed=seed)
    cfg = dataclasses.replace(exact_config(n_rep, doorbell, "scan"),
                              seed=seed)
    t0 = time.perf_counter()
    mem = DHNSWEngine(cfg, device=device).build(ds.data)
    t1 = time.perf_counter()
    rows = n // n_chunks
    stream = DHNSWEngine(cfg, device=device).build_streaming(
        chunked_source(ds.data, rows), chunk_rows=rows)
    t2 = time.perf_counter()
    rep = stream.last_load_report
    for a in ("reps", "rep_ids", "assignments"):
        if not np.array_equal(getattr(mem.meta, a), getattr(stream.meta, a)):
            raise AssertionError(f"load: meta {a} differ")
    for a in ("vectors", "adjacency", "node_level"):
        if (getattr(mem.meta.graph, a).tobytes()
                != getattr(stream.meta.graph, a).tobytes()):
            raise AssertionError(f"load: meta graph {a} differ")
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        x, y = getattr(mem.store, a), getattr(stream.store, a)
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f"load: region {a} differs")
    for a in ("_g_dev", "_v_dev", "_mt_dev"):
        if not torch.equal(getattr(mem.pool, a), getattr(stream.pool, a)):
            raise AssertionError(f"load: device region {a} differs")
    if (rep.chunks_total, rep.chunks_ok, rep.chunks_failed) != (
            n_chunks, n_chunks, 0):
        raise AssertionError(f"load: report {rep}")
    if not rep.peak_builder_bytes < rep.dataset_bytes / 2:
        raise AssertionError(f"load: peak builder {rep.peak_builder_bytes} "
                             f"B of a {rep.dataset_bytes} B dataset")
    launches = {name: 0 for name in KERNEL_OPS}
    with CallLog(GO, "gather_spans") as calls:
        out = []
        for e in (mem, stream):
            out.append(_search(e, ds.queries, k, device))
            for key in launches:
                launches[key] += out[-1][4][key]
    (d0, g0, st0, w0, _), (d1, g1, st1, w1, _) = out
    if not (np.array_equal(d0, d1) and np.array_equal(g0, g1)
            and _counted_equal(st0, st1)):
        raise AssertionError("load: streamed and in-memory engines search "
                             "differently")
    _check_output(d0, g0, n_queries, k, n, "load")
    bufs = {}
    recorded = recorded_launches(calls.calls, bufs, "load.")
    log(f"[11 load] {n} rows, n_rep {n_rep}: build {t1 - t0:.2f} s, "
        f"build_streaming {t2 - t1:.2f} s in {rep.chunks_total} chunks of "
        f"{rows} (0 failed), peak builder {rep.peak_builder_bytes / 1e6:.3f}"
        f" MB of a {rep.dataset_bytes / 1e6:.3f} MB dataset | meta, host "
        f"and device regions bit-identical | {n_queries} queries: gids and "
        f"distances bit-identical, recall@{k} "
        f"{recall_at_k(g0, ds.gt_ids[:, :k]):.4f}, wall {w0:.4f} / "
        f"{w1:.4f} s | gather launches {launches['gather_blocks']}")
    return launches, recorded, bufs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="phase 4 also times every launch shape of the "
                         "streaming kernels")
    args = ap.parse_args(argv)
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
    ins_launches, ins_recorded, ins_bufs = phase_insert(
        ds, meta, store, qstore, device, k=FULL["k"],
        doorbell=FULL["doorbell"], scan_recall=scan_stats["recall_at_k"])
    load_launches, load_recorded, load_bufs = phase_load(
        device, doorbell=FULL["doorbell"], **LOAD)
    for name in launches:
        launches[name] += ins_launches[name] + load_launches[name]
    planned = gather_launches(gathers, pair_gathers, rag_gathers,
                              ins_recorded + load_recorded)
    if launches["gather_blocks"] != len(planned):
        raise AssertionError(f"{launches['gather_blocks']} gather launches on "
                             f"the main path, {len(planned)} span reads "
                             f"planned (one launch each)")
    q, k, v, pos = first
    records = phase_kernels(store, qstore, ds.data, ds.queries, planned,
                            device, decode_shapes=[
                                ("path", q, k, v, pos),
                                ("long", *long_decode_inputs(
                                    **DECODE_LONG, H=q.shape[1],
                                    K=k.shape[2], hd=q.shape[2],
                                    dtype=q.dtype, device=device))],
                            sweep=args.sweep,
                            extra_bufs={**ins_bufs, **load_bufs})
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

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
   the main path gives them (for the gather, the ids of every round of
   one exact batch, planned as the engine plans them), with times (CUDA
   events) beside the bound, the plain version's time and the library
   call's time;
5. exact search (``mode="full"``, b=4, ef=48, doorbell 16, RDMA fabric,
   the CUDA doorbell gather) for ``search_mode`` graph and scan, one batch
   of 2000 at k=10, held against the same engine with the gather off;
6. int8 flat search (``quant_kernel="auto"``: the CUDA ``quant_topk``
   stage 1), held against ``quant_kernel="ref"``.

Every kernel's launch counter is set to 0 just before each main-path
search and read just after.  The last lines are the kernels' JSON
record, the ``nvidia-smi`` line, and ``{"ok": true, "device": ...}``.
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

from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core import device_store as DS  # noqa: E402
from repro_torch.core import layout as LA  # noqa: E402
from repro_torch.core import meta as ME  # noqa: E402
from repro_torch.core import scheduler as SCH  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G  # noqa: E402
from repro_torch.core.hnsw import HNSWParams, recall_at_k  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gather_blocks import ops as GO  # noqa: E402
from repro_torch.kernels.gather_blocks.ref import gather_blocks_ref  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
from repro_torch.kernels.quant_topk.ref import (  # noqa: E402
    ids_agree_up_to_ties, quant_topk_ref)

# H100 SXM published peaks (NVIDIA datasheet), at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12

# the paper's SIFT1M run is 1M x 128-d with 500 partitions; the host-side
# index build (pure-Python HNSW) takes ~90 s at 100k, so both are cut
REDUCED = {"n": [1_000_000, 100_000], "n_rep": [500, 256],
           "why": "host-side index build time (pure-Python HNSW)"}
FULL = dict(n=100_000, n_queries=2000, n_rep=256, k=10, doorbell=16)
SEED = 0
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-3
RECALL_FLOOR = 0.8           # sanity floor for recall@10 at full size


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
    ``ComputeClient._sync_flat`` stages it: (codes, scales, n_valid)."""
    spec = qstore.spec
    rows, _, _ = LA.flat_quant_rows(qstore)
    n = len(rows)
    idx = np.full(SCH.pow2_pad(max(n, 1), lo=256), -1, np.int64)
    idx[:n] = rows
    codes, scales = DS.gather_quant_rows(
        torch.as_tensor(qstore.qvec_buf, device=device),
        torch.as_tensor(qstore.qscale_buf, device=device),
        torch.as_tensor(idx, dtype=torch.int32, device=device),
        dim=spec.dim, group=spec.quant_group)
    return codes, scales, n


def exact_config(n_rep: int, doorbell: int, search_mode: str = "scan",
                 gather: bool = True) -> EngineConfig:
    """The exact main path: ``mode="full"``, b=4, ef=48, RDMA fabric."""
    return EngineConfig(mode="full", search_mode=search_mode, b=4, ef=48,
                        n_rep=n_rep, doorbell=doorbell, fabric=RDMA_100G,
                        use_gather_kernel=gather)


def main_path_gathers(meta, store, queries, device, *, doorbell: int):
    """The block ids of every span read of one exact batch, round by
    round, planned as ``ComputeClient.search`` plans them on a fresh
    engine: meta-HNSW routing on ``device``, then ``plan_batch`` over an
    empty cache of ``ceil(cache_frac * n_rep)`` slots.  Each round reads
    all its fetched spans in one ``read_spans`` call, which is one gather
    launch per staged buffer.  Returns (ids per round, fetched spans)."""
    cfg = exact_config(meta.n_partitions, doorbell)
    g = meta.graph
    pids, _ = S.meta_route(
        torch.as_tensor(g.vectors, dtype=torch.float32, device=device),
        torch.as_tensor(g.adjacency, dtype=torch.int32, device=device),
        torch.as_tensor(queries, dtype=torch.float32, device=device),
        int(g.entry), b=cfg.b, n_levels=g.n_levels)
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    plan = SCH.plan_batch(pids.cpu().numpy(), SCH.LRUCacheState(cap),
                          doorbell=cfg.doorbell)
    ids = [torch.as_tensor(
        np.concatenate([store.span_block_ids(int(p)) for p in rnd.fetch_pids]),
        dtype=torch.int32, device=device)
        for rnd in plan.rounds if len(rnd.fetch_pids)]
    return ids, plan.n_fetches


def _gather_record(bufs, round_ids, device, timed: bool) -> dict:
    """gather_blocks vs its plain version on every staged buffer at the
    ids of every round of one exact batch (exactly equal).  The record's
    work is what the exact path gathers in that batch: the graph and
    vector blocks of every round, in the path's order."""
    worst = 0.0
    bound_s = 0.0
    for name, buf in bufs.items():
        row_bytes = buf.shape[1] * buf.element_size()
        for ids in round_ids:
            got = GO.gather_blocks(buf, ids)
            want = gather_blocks_ref(buf, ids)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"gather_blocks != plain on {name}")
            worst = max(worst,
                        float((got.double() - want.double()).abs().max()))
        rows = [int(ids.shape[0]) for ids in round_ids]
        nbytes = sum(2 * m * row_bytes + 4 * m for m in rows)
        if name in ("graph", "vec"):
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
        path_bufs = (bufs["graph"], bufs["vec"])
        outs = [[torch.empty((ids.shape[0], b.shape[1]), dtype=b.dtype,
                             device=device) for b in path_bufs]
                for ids in round_ids]
        bad = torch.zeros(1, dtype=torch.int32, device=device)

        def kern():
            for ids, out in zip(round_ids, outs):
                for b, o in zip(path_bufs, out):
                    GO._launch(b, ids, o, bad)

        def plain():
            for ids in round_ids:
                for b in path_bufs:
                    gather_blocks_ref(b, ids)

        def library():
            for ids in round_ids:
                for b in path_bufs:
                    torch.index_select(b, 0, ids)

        rec["ms"] = device_ms(kern, 20)
        rec["plain_ms"] = device_ms(plain, 20)
        rec["library_ms"] = device_ms(library, 20)
        if bad.item():
            raise AssertionError("gather_blocks flagged an id out of range")
    log(f"[4 kernels] gather_blocks, one exact batch (graph + vector blocks,"
        f" {2 * len(round_ids)} launches): "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"index_select {rec['library_ms']:.4f} ms, " if timed else "")
        + f"bound {rec['bound_ms']:.4f} ms (bytes)")
    return rec


def phase_kernels(store, qstore, queries, round_ids, device, *, k: int = 20
                  ) -> list:
    """Phase 4: each kernel against its plain version at the main path's
    shapes.  gather_blocks: the ids of every round of one exact batch
    (``main_path_gathers``) on each staged buffer (int32 graph blocks, f32
    vector blocks, int8 codes, f32 scales), exactly equal.  quant_topk:
    the flat stage-1 call (all queries against the padded flat int8
    database), ids equal up to ties and distances within rtol 1e-5 /
    atol 1e-3.  Times only on the card."""
    timed = device.type == "cuda"
    bufs = {"graph": torch.as_tensor(store.graph_buf, device=device),
            "vec": torch.as_tensor(store.vec_buf, device=device),
            "codes": torch.as_tensor(qstore.qvec_buf, device=device),
            "scales": torch.as_tensor(qstore.qscale_buf, device=device)}
    records = [_gather_record(bufs, round_ids, device, timed)]

    codes, scales, n_valid = flat_view(qstore, device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    group = qstore.spec.quant_group
    B, D = q.shape
    kk = min(k, n_valid)
    d, i = QO.quant_topk(q, codes, scales, kk, group, n_valid=n_valid)
    dr, ir = quant_topk_ref(q, codes, scales, kk + 1, group, n_valid)
    d_h, i_h = d.cpu().numpy(), i.cpu().numpy()
    dr_h, ir_h = dr.cpu().numpy(), ir.cpu().numpy()
    ok, n_diff = ids_agree_up_to_ties(i_h, ir_h, dr_h, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"quant_topk ids differ from plain beyond ties "
                             f"({n_diff} positions)")
    np.testing.assert_allclose(d_h, dr_h[:, :kk], rtol=TOPK_RTOL,
                               atol=TOPK_ATOL)
    q_err = float(np.abs(d_h - dr_h[:, :kk]).max())
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
        bufs_q = (torch.empty((B, S, kk), dtype=torch.float32, device=device),
                  torch.empty((B, S, kk), dtype=torch.int32, device=device),
                  torch.empty((B, kk), dtype=torch.float32, device=device),
                  torch.empty((B, kk), dtype=torch.int32, device=device))
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
    return records


def _reset_launches() -> None:
    GO.launches = 0
    QO.launches = 0


def _launches() -> dict:
    return {"gather_blocks": GO.launches, "quant_topk": QO.launches}


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


def _in_turns(make_engine, variants, queries, k: int, device) -> dict:
    """Search one batch with a fresh engine per variant, in turns
    (a, b, b, a), so that neither variant alone pays the warm-up.  Returns
    variant -> the first run's (d, g, stats, launches) and both walls."""
    out = {}
    for v in (*variants, *variants[::-1]):
        d, g, st, wall, n = _search(make_engine(v), queries, k, device)
        if v in out:
            out[v]["walls"].append(wall)
        else:
            out[v] = {"d": d, "g": g, "st": st, "launches": n,
                      "walls": [wall]}
    return out


def _host_split(st) -> str:
    return (f"route {st['meta_s']:.3f} s, plan {st['plan_s']:.3f} s, "
            f"serve {st['sub_s']:.3f} s")


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
    Returns the gather launches of the main path."""
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
        n_launch = on["launches"]["gather_blocks"]
        if off["launches"]["gather_blocks"]:
            raise AssertionError("gather_blocks launched with the gather off")
        want = 2 * len(round_ids) if device.type == "cuda" else 0
        if n_launch != want or on["st"]["n_fetches"] != n_fetches:
            raise AssertionError(
                f"exact {search_mode}: {n_launch} gather launches and "
                f"{on['st']['n_fetches']} fetches, planned {want} and "
                f"{n_fetches}")
        launches += n_launch
        d, g, st = on["d"], on["g"], on["st"]
        _check_output(d, g, B, k, n, f"exact {search_mode}")
        if not (np.array_equal(g, off["g"]) and np.array_equal(d, off["d"])):
            raise AssertionError(f"exact {search_mode}: gather kernel on/off "
                                 "results differ")
        rec = recall_at_k(g, ds.gt_ids[:, :k])
        if rec < recall_floor:
            raise AssertionError(f"exact {search_mode}: recall@{k} {rec}")
        log(f"[5 exact {search_mode}] recall@{k}={rec:.4f} | {_counted(st)}"
            f" | gather launches {n_launch} | wall s gather on "
            f"{on['walls']}, off {off['walls']} (off, on, on, off) | host "
            f"split (on, first run): {_host_split(st)} | equal to gather off")
    return {"gather_blocks": launches}


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
    d, g, st = auto["d"], auto["g"], auto["st"]
    dr, gr, sr = ref["d"], ref["g"], ref["st"]
    launches = auto["launches"]["quant_topk"]
    want = "cuda" if device.type == "cuda" else "ref"
    if st["stage1_impl"] != want or sr["stage1_impl"] != "ref":
        raise AssertionError(f"stage1_impl {st['stage1_impl']} / "
                             f"{sr['stage1_impl']}")
    if device.type == "cuda" and launches == 0:
        raise AssertionError("quant_topk was not launched")
    if ref["launches"]["quant_topk"]:
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
        f" | wall s auto {auto['walls']}, ref {ref['walls']} (ref, auto, "
        f"auto, ref) | host split (auto, first run): {_host_split(st)} | "
        f"{n_diff} positions differ from the ref, all at ties")
    return {"quant_topk": launches}


def main() -> int:
    dev_info = phase_device()
    device = torch.device("cuda")
    log("reduced: " + json.dumps(REDUCED))
    phase_kernel_build()
    ds, meta, store, qstore = phase_index(FULL["n"], FULL["n_queries"],
                                          FULL["n_rep"])
    gathers = main_path_gathers(meta, store, ds.queries, device,
                                doorbell=FULL["doorbell"])
    records = phase_kernels(store, qstore, ds.queries, gathers[0], device)
    launches = phase_exact(ds, meta, store, device, k=FULL["k"],
                           doorbell=FULL["doorbell"], gathers=gathers,
                           recall_floor=RECALL_FLOOR)
    launches.update(phase_int8(ds, meta, qstore, device, k=FULL["k"],
                               doorbell=FULL["doorbell"],
                               recall_floor=RECALL_FLOOR))
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

"""Quantized-tier sweep through the PyTorch/CUDA port (the port of
``benchmarks/quant.py``): recall vs bytes on the wire across tier splits.

For each scheme the staged int8 path is compared against the exact
single-tier engine at the SAME cache byte budget:

  * ``quant=none``  — every miss moves a full-precision span;
  * ``quant=int8``  — stage-1 misses move int8 codes + codebook blocks
                      into a ~3-4x larger quantized tier (the per-pair
                      stage 1), stage 2 moves only the candidate rows it
                      re-ranks.

The sweep axes are the tier split (``exact_frac``) and the re-rank pool
(``rerank_m``).  Each cell runs several query batches (so tier reuse, not
just the cold fetch, is measured) and reports recall@10 against the
dataset's exact ground truth next to total fetched/saved bytes.  Two more
cells raise the cache budget until the quantized tier holds every
partition, so stage 1 becomes the flat ``quant_topk`` scan ("auto": the
CUDA kernel on the card; "ref": its plain version).  ``kernel_ab`` times
``quant_topk`` against its plain version on a flat database.

    PYTHONPATH=src python benchmarks/torch_quant.py --smoke [--device cpu]

Writes ``BENCH_torch_quant.json``.  ``--smoke`` is the reference's tiny
config, whose counted rows (MB, MB saved, round trips, slots, recall)
equal ``benchmarks/baselines/BENCH_quant.json``'s.  Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G
from repro_torch.core.hnsw import recall_at_k
from repro_torch.data.synthetic import sift_like
from repro_torch.obs.trace import TRACER


def cell_config(*, quant: str, exact_frac: float, rerank_m: int, n_rep: int,
                quant_kernel: str = "off", cache_frac: float = 0.25,
                seed: int = 0, **kw) -> EngineConfig:
    """One cell's engine config (``kw`` overrides, e.g. ``search_mode``)."""
    cfg = dict(mode="full", search_mode="scan", b=6, ef=48, n_rep=n_rep,
               cache_frac=cache_frac, doorbell=16, fabric=RDMA_100G,
               seed=seed, quant=quant, exact_frac=exact_frac,
               rerank_m=rerank_m, quant_kernel=quant_kernel)
    cfg.update(kw)
    return EngineConfig(**cfg)


def run_cell(data, queries, gt, *, quant: str, exact_frac: float,
             rerank_m: int, n_rep: int, n_batches: int, k: int = 10,
             quant_kernel: str = "off", cache_frac: float = 0.25,
             seed: int = 0, device="cuda") -> dict:
    eng = DHNSWEngine(cell_config(
        quant=quant, exact_frac=exact_frac, rerank_m=rerank_m, n_rep=n_rep,
        quant_kernel=quant_kernel, cache_frac=cache_frac, seed=seed),
        device=device).build(data)
    per = max(len(queries) // n_batches, 1)
    tot_bytes = tot_saved = trips = 0.0
    recs = []
    t0 = time.perf_counter()
    for i in range(n_batches):
        qb = queries[i * per:(i + 1) * per]
        _, g, st = eng.search(qb, k=k)
        tot_bytes += st["net"]["bytes"]
        tot_saved += st["net"]["bytes_saved"]
        trips += st["net"]["round_trips"]
        recs.append(recall_at_k(g, gt[i * per:(i + 1) * per, :k]))
    wall = time.perf_counter() - t0
    row = {"quant": quant, "recall": round(float(np.mean(recs)), 4),
           "mbytes": round(tot_bytes / 1e6, 3),
           "mbytes_saved": round(tot_saved / 1e6, 3),
           "round_trips": trips, "wall_s": round(wall, 2)}
    if quant != "none":
        row.update(exact_frac=exact_frac, rerank_m=rerank_m,
                   quant_slots=eng.tiers.quant.capacity,
                   exact_slots=eng.tiers.exact.capacity)
    if quant_kernel != "off":
        row.update(quant_kernel=quant_kernel,
                   kernel_active=st.get("quant_kernel") == "flat")
    return row


def kernel_ab(n: int = 4096, d: int = 128, k: int = 10, seed: int = 0,
              device="cuda") -> dict:
    """``quant_topk`` (the CUDA kernel on the card, the plain version on
    the CPU) against its plain version on a flat database."""
    from repro_torch.kernels.quant_topk.ops import quant_topk
    from repro_torch.quant.codec import quantize_groups

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((64, d)).astype(np.float32)
    codes, scales = quantize_groups(x, 32)
    qt, ct, st = (torch.as_tensor(a, device=dev) for a in (q, codes, scales))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    impl = "cuda" if dev.type == "cuda" else "plain"
    out = {}
    for name, use_ref in ((impl, False), ("ref", True)):
        quant_topk(qt, ct, st, k, 32, use_ref=use_ref)
        sync()
        t0 = time.perf_counter()
        dd, ii = quant_topk(qt, ct, st, k, 32, use_ref=use_ref)
        sync()
        out[f"{name}_us"] = round((time.perf_counter() - t0) * 1e6, 1)
        out[name] = ii.cpu().numpy()
    match = float(np.mean(out[impl] == out["ref"]))
    return {"bench": "quant_topk_kernel", "n": n, "d": d, "k": k,
            "impl": impl, "id_match": match, "kernel_us": out[f"{impl}_us"],
            "ref_us": out["ref_us"],
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def run(*, smoke: bool = False, out: str = "BENCH_torch_quant.json",
        seed: int = 0, device="cuda", trace_out: str | None = None) -> dict:
    # --trace records the kernel A/B: every quant_topk call becomes a
    # ``kernel.quant_topk`` span tagged with impl=cuda|ref
    if trace_out:
        TRACER.configure()
        TRACER.set_phase("kernel_ab")
    if smoke:
        n, n_rep, n_batches = 1500, 12, 2
        splits, pools = (0.25,), (0,)
        kab = kernel_ab(n=512, d=64, k=5, seed=seed, device=device)
    else:
        n, n_rep, n_batches = 20_000, 64, 4
        splits, pools = (0.0, 0.25, 0.5), (0, 20, 40)
        kab = kernel_ab(seed=seed, device=device)
    if trace_out:
        TRACER.set_phase(None)
    ds = sift_like(n=n, n_queries=256, seed=seed)
    cell = dict(n_rep=n_rep, n_batches=n_batches, seed=seed, device=device)

    rows = [run_cell(ds.data, ds.queries, ds.gt_ids, quant="none",
                     exact_frac=0.25, rerank_m=0, **cell)]
    base = rows[0]["mbytes"]
    print(f"{'quant':6s} {'split':>5s} {'m':>4s} {'recall':>7s} "
          f"{'MB':>9s} {'saved MB':>9s} {'reduction':>9s}")
    print(f"{'none':6s} {'-':>5s} {'-':>4s} {rows[0]['recall']:7.4f} "
          f"{base:9.2f} {'-':>9s} {'-':>9s}", flush=True)
    for split in splits:
        for m in pools:
            row = run_cell(ds.data, ds.queries, ds.gt_ids, quant="int8",
                           exact_frac=split, rerank_m=m, **cell)
            row["bytes_reduction"] = round(base / max(row["mbytes"], 1e-9), 2)
            rows.append(row)
            print(f"{'int8':6s} {split:5.2f} {m:4d} {row['recall']:7.4f} "
                  f"{row['mbytes']:9.2f} {row['mbytes_saved']:9.2f} "
                  f"x{row['bytes_reduction']:8.2f}", flush=True)

    # dense-resident flat stage 1: quant_topk over the whole resident
    # int8 database (cache budget raised so the quantized tier holds
    # every partition)
    for qk in ("auto", "ref"):
        row = run_cell(ds.data, ds.queries, ds.gt_ids, quant="int8",
                       exact_frac=0.25, rerank_m=0, quant_kernel=qk,
                       cache_frac=0.6, **cell)
        row["bytes_reduction"] = round(base / max(row["mbytes"], 1e-9), 2)
        rows.append(row)
        tag = {"auto": "flatk", "ref": "flatr"}[qk]
        print(f"{tag:6s} {0.25:5.2f} {0:4d} {row['recall']:7.4f} "
              f"{row['mbytes']:9.2f} {row['mbytes_saved']:9.2f} "
              f"x{row['bytes_reduction']:8.2f}  "
              f"active={row['kernel_active']}", flush=True)

    print(f"kernel A/B: id_match {kab['id_match']:.3f}  "
          f"{kab['impl']} {kab['kernel_us']} us vs ref {kab['ref_us']} us")
    if trace_out:
        n_spans = TRACER.save(trace_out)
        TRACER.disable()
        print(f"wrote {trace_out} ({n_spans} spans)")
    blob = {"bench": "quant", "smoke": smoke, "n": n, "n_rep": n_rep,
            "n_batches": n_batches, "rows": rows, "kernel": kab}
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out} ({len(rows)} rows)")
    return blob


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny CI config")
    ap.add_argument("--out", default="BENCH_torch_quant.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record the run with repro_torch.obs; write "
                         "Chrome-trace JSON to FILE")
    args = ap.parse_args()
    run(smoke=args.smoke, out=args.out, seed=args.seed, device=args.device,
        trace_out=args.trace)


if __name__ == "__main__":
    main()

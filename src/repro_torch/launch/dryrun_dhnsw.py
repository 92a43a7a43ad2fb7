"""Multi-pod dry run of the d-HNSW serving step itself, on torch.

Port of ``repro/launch/dryrun_dhnsw.py``: the distributed fetch + serve
step (the paper's technique) at SIFT1M scale on the production meshes,
with the reference's geometry constants.  ``make_step(mesh, variant)``
returns ``(step, specs, in_shardings, out_shardings)``; ``step`` takes
DTensors placed by ``in_shardings`` and runs on fake tensors over the
fake backend (``run``: the dry run, no store allocated) or on real
tensors over a real group (``chip_smoke.py`` phase 19e: the 721 MB f32
store, 180 MB in int8, over 4 gloo ranks on one card).

Step under test (one batch round, steady state):
  1. doorbell fetch: m partition spans gathered from the sharded block
     region (one all-reduce over ``model``);
  2. decode + distance/top-k over the fetched partitions for the round's
     (query, partition) pairs (``torch.bmm``, as the reference's product
     is outside any kernel; top-k by a stable sort, the lower index
     first on ties);
  3. per-query top-k.

Variants: ``baseline`` (store sharded over ``model``, the fetch
replicated to every rank), ``sharded`` (pairs sharded over the batch
axes: each replica fetches its own round), ``quantized`` (+ int8 wire),
``int8_rest`` (+ int8 store), ``span_dma`` (+ one contiguous slice a
span, shard bounds group-aligned), ``bf16_serve`` (+ bf16 distances).

``run`` reports per device: the collectives (``dryrun.count_collectives``),
the FLOPs (``FlopCounterMode``: products only, where XLA's count also
has the elementwise work), the bytes every op reads and writes (views
aside: XLA's "bytes accessed"; a row gather is charged its whole
operand, as in XLA, and so is ``span_dma``'s span read, an index of
consecutive rows here where XLA slices), the argument bytes from the
placements, and the roofline terms over the H100's own peaks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_dhnsw [--multi-pod]
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.core.distributed import shard_map_compat
from repro_torch.core.mesh import (CollectiveCounter, NamedSharding, P,
                                   axis_names, axis_size, coordinate,
                                   group)
from repro_torch.launch.dryrun import BytesCounter
from repro_torch.launch.mesh import fake_world, make_production_mesh

# SIFT1M-scale store geometry (paper: 1M x 128d, 500 partitions)
DIM = 128
DEG = 16
NP_MAX = 2_560            # ~1M/500 padded
OV_CAP = 512
SLOT_VECS = 64
N_PARTS = 500
M_FETCH = 16              # spans per doorbell batch (per compute replica)
PAIRS = 64                # (query, partition) pairs served per round
K = 10

GBLK = SLOT_VECS * (DEG + 1)
VBLK = SLOT_VECS * DIM
DATA_BLOCKS = -(-NP_MAX * (DEG + 1) // GBLK)
_DB_V = -(-NP_MAX * DIM // VBLK)
DATA_BLOCKS = max(DATA_BLOCKS, _DB_V)
OV_BLOCKS = max(-(-OV_CAP // GBLK), -(-OV_CAP * DIM // VBLK))
FETCH_BLOCKS = DATA_BLOCKS + OV_BLOCKS
N_BLOCKS = ((N_PARTS + 1) // 2) * (2 * DATA_BLOCKS + OV_BLOCKS)
GROUP_BLOCKS = 2 * DATA_BLOCKS + OV_BLOCKS

VARIANTS = ("baseline", "sharded", "quantized", "int8_rest", "span_dma",
            "bf16_serve")

# H100 SXM (NVIDIA datasheet, 700 W): f32 FMA (TF32 off) and dense bf16
# tensor-core peaks, HBM3 bandwidth, NVLink 4 per direction (900 GB/s
# both ways)
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES = 3.35e12
H100_NVLINK_BYTES = 450e9


def geometry(mesh, variant: str) -> tuple:
    """(n_blocks, per_shard) of the store over ``model``."""
    tp = axis_size(mesh, "model")
    n_blocks = N_BLOCKS + ((-N_BLOCKS) % tp)
    per_shard = n_blocks // tp
    if variant in ("span_dma", "bf16_serve"):
        # group-align the shard boundary so no fetch span straddles two
        # memory owners (production build rule; costs <1 group of pad)
        per_shard = -(-per_shard // GROUP_BLOCKS) * GROUP_BLOCKS
        n_blocks = per_shard * tp
    return n_blocks, per_shard


def _gather_fn(per_shard: int, mesh):
    grp = group(mesh, "model")

    def local_gather(buf, ids):
        lo = coordinate(mesh, "model") * per_shard
        local = ids.long() - lo
        mine = (local >= 0) & (local < per_shard)
        rows = buf[torch.where(mine, local, 0)]
        rows = torch.where(mine[:, None], rows, torch.zeros((), dtype=buf.dtype,
                                                            device=buf.device))
        dist.all_reduce(rows, group=grp)
        return rows
    return local_gather


def serve(v_rows, queries, pair_valid, dtype=torch.float32):
    """v_rows: (PAIRS, FETCH_BLOCKS*VBLK) fetched spans -> (distances,
    ids) (PAIRS, K), the K nearest of each pair's partition."""
    vecs = v_rows[:, : NP_MAX * DIM].reshape(PAIRS, NP_MAX, DIM).to(dtype)
    qd = queries.to(dtype)
    q2 = (qd.float() ** 2).sum(-1)[:, None]
    x2 = (vecs.float() ** 2).sum(-1)
    # the product in f32 over the dtype's values (preferred_element_type)
    dots = torch.bmm(vecs.float(), qd.float()[:, :, None])[..., 0]
    d = q2 + x2 - 2.0 * dots
    d = torch.where(pair_valid[:, None], d, torch.inf)
    nd, ni = torch.sort(d, dim=-1, stable=True)
    return nd[:, :K], ni[:, :K]


def make_step(mesh, variant: str):
    axis = "model"
    n_blocks, per_shard = geometry(mesh, variant)
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    local_gather = _gather_fn(per_shard, mesh)
    scale = 1.0 / 127.0
    # the f32 scale rounded to each serve dtype (``scale.astype(sdt)``)
    scale_in = {dt: float(torch.tensor(scale, dtype=torch.float32).to(dt))
                for dt in (torch.float32, torch.bfloat16)}

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    if variant == "baseline":
        # replicated fetch: every rank receives every span (the paper's
        # "cache in each compute instance" done naively)
        gather = shard_map_compat(local_gather, mesh=mesh,
                                  in_specs=(P(axis, None), P()),
                                  out_specs=P())

        def serve_all(v, slot, q, valid):
            return serve(v.reshape(M_FETCH, -1)[slot.long()], q, valid)
        served = shard_map_compat(serve_all, mesh=mesh, in_specs=(P(),) * 4,
                                  out_specs=(P(), P()))

        def step(vec_buf, block_ids, queries, pair_slot, pair_valid):
            return served(gather(vec_buf, block_ids), pair_slot, queries,
                          pair_valid)

        specs = dict(vec=meta((n_blocks, VBLK), torch.float32),
                     ids=meta((M_FETCH * FETCH_BLOCKS,), torch.int32),
                     q=meta((PAIRS, DIM), torch.float32),
                     slot=meta((PAIRS,), torch.int32),
                     valid=meta((PAIRS,), torch.bool))
        in_sh = (NamedSharding(mesh, P(axis, None)),) + tuple(
            NamedSharding(mesh, P()) for _ in range(4))
        return step, specs, in_sh, NamedSharding(mesh, P())

    # sharded and beyond: each data-replica fetches ITS OWN doorbell batch
    # and serves ITS OWN pairs (wire bytes / data-degree)
    dp = 1
    for a in batch_axes:
        dp *= axis_size(mesh, a)
    bspec = P(batch_axes, None) if batch_axes else P()
    grp = group(mesh, axis)

    def span_dma_gather(buf, starts):
        """M_FETCH contiguous span slices (the layout's payoff: one READ
        per partition + overflow), assembled by one all-reduce."""
        lo = coordinate(mesh, axis) * per_shard
        outs = []
        for m in range(M_FETCH):
            s = starts[m]
            mine = (s >= lo) & (s < lo + per_shard)
            sl = torch.clamp(s - lo, 0, per_shard - FETCH_BLOCKS)
            # the span's FETCH_BLOCKS consecutive rows: an index on the
            # device (a slice at a host offset would read the start back)
            rows = buf[sl + torch.arange(FETCH_BLOCKS, device=buf.device)]
            outs.append(torch.where(mine, rows, torch.zeros(
                (), dtype=buf.dtype, device=buf.device)))
        spans = torch.stack(outs)        # (M_FETCH, FETCH_BLOCKS, VBLK)
        dist.all_reduce(spans, group=grp)
        return spans

    def shard_body(buf, ids, q, slot, valid):
        slot = slot[0].long()
        if variant in ("span_dma", "bf16_serve"):
            starts = ids.reshape(M_FETCH, FETCH_BLOCKS)[:, 0].long()
            rows8 = span_dma_gather(buf, starts)
            sdt = torch.bfloat16 if variant == "bf16_serve" else torch.float32
            rows = rows8.to(sdt) * scale_in[sdt]
            rows = rows.reshape(M_FETCH, -1)[slot]
            d, i = serve(rows, q[0], valid[0], dtype=sdt)
            return d[None], i[None]
        ids = ids.reshape(-1)
        if variant == "quantized":
            q8 = torch.clamp(torch.round(buf / scale), -127, 127).to(
                torch.int8)
            rows = local_gather(q8, ids).float() * scale
        elif variant == "int8_rest":
            rows = local_gather(buf, ids).float() * scale
        else:
            rows = local_gather(buf, ids)
        rows = rows.reshape(M_FETCH, -1)[slot]
        d, i = serve(rows, q[0], valid[0])
        return d[None], i[None]

    body = shard_map_compat(shard_body, mesh=mesh,
                            in_specs=(P(axis, None), bspec, bspec, bspec,
                                      bspec),
                            out_specs=(bspec, bspec))

    def step(vec_buf, block_ids, queries, pair_slot, pair_valid):
        return body(vec_buf, block_ids, queries, pair_slot, pair_valid)

    vec_dtype = (torch.int8 if variant in ("int8_rest", "span_dma",
                                           "bf16_serve") else torch.float32)
    specs = dict(vec=meta((n_blocks, VBLK), vec_dtype),
                 ids=meta((dp, M_FETCH * FETCH_BLOCKS), torch.int32),
                 q=meta((dp, PAIRS, DIM), torch.float32),
                 slot=meta((dp, PAIRS), torch.int32),
                 valid=meta((dp, PAIRS), torch.bool))
    in_sh = (NamedSharding(mesh, P(axis, None)),) + tuple(
        NamedSharding(mesh, bspec) for _ in range(4))
    out_sh = (NamedSharding(mesh, bspec), NamedSharding(mesh, bspec))
    return step, specs, in_sh, out_sh


def fake_args(specs: dict, in_sh) -> tuple:
    from repro_torch.launch.dryrun import _fake_dtensor
    return tuple(_fake_dtensor(specs[k], sh)
                 for k, sh in zip(("vec", "ids", "q", "slot", "valid"), in_sh))


def count(mesh, variant: str) -> dict:
    """``variant``'s step on ``mesh`` (a mesh of the fake backend) traced
    on fake tensors: its collectives, FLOPs, bytes accessed and argument
    bytes, each one device's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    step, specs, in_sh, _ = make_step(mesh, variant)
    arg_bytes = sum(sh.shard_bytes(specs[k]) for k, sh in zip(
        ("vec", "ids", "q", "slot", "valid"), in_sh))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = fake_args(specs, in_sh)
        flops = FlopCounterMode(display=False)
        with CollectiveCounter() as cc, flops, BytesCounter() as bc:
            step(*args)
    return {"collectives": cc.summary(), "flops": flops.get_total_flops(),
            "bytes": bc.total, "arg_bytes": int(arg_bytes)}


def run(variant: str, multi_pod: bool) -> dict:
    n_dev = 512 if multi_pod else 256
    fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    c = count(mesh, variant)
    coll = c["collectives"]
    peak = H100_BF16_FLOPS if variant == "bf16_serve" else H100_F32_FLOPS
    res = {
        "cell": f"dhnsw-serve/{variant}",
        "mesh": "multi" if multi_pod else "single",
        "n_devices": n_dev,
        "flops_dev": float(c["flops"]),
        "bytes_dev": float(c["bytes"]),
        "wire_dev": float(coll["wire_bytes_per_device"]),
        "coll_kinds": coll["operand_bytes_by_kind"],
        "n_collectives": coll["n_collectives"],
        "arg_bytes": c["arg_bytes"],
        "temp_bytes": None,
        "peaks": {"flops": peak, "hbm_bytes": H100_HBM_BYTES,
                  "link_bytes": H100_NVLINK_BYTES,
                  "source": "H100 SXM datasheet"},
    }
    res["t_compute"] = res["flops_dev"] / peak
    res["t_memory"] = res["bytes_dev"] / H100_HBM_BYTES
    res["t_collective"] = res["wire_dev"] / H100_NVLINK_BYTES
    terms = {k: res[f"t_{k}"] for k in ("compute", "memory", "collective")}
    res["dominant"] = max(terms, key=terms.get)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="all", choices=list(VARIANTS)
                    + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    variants = VARIANTS if args.variant == "all" else [args.variant]
    for v in variants:
        res = run(v, args.multi_pod)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()

"""Multi-pod dry run: trace every (arch x shape x mesh) cell, on torch.

Port of ``repro/launch/dryrun.py``: the same CLI, JSONL keys,
``MICRO_OVERRIDES`` and skip rules.  Where the reference lowers and
compiles each cell with XLA on 512 fake host devices, this traces the
port's meshed step (``train_step.make_step``) in one process that plays
every rank: the fake backend (``launch.mesh.fake_world``) under
``FakeTensorMode``, on the production mesh, nothing allocated.

* ``memory``: each device's bytes of the parameters, optimizer state,
  cache and inputs, from their placements (exact; the full depth).
  ``argument_size_bytes`` is their sum, the reference's compiled
  argument size.  ``peak_transient_bytes`` is the peak of what the
  traced step allocates on top (``PeakCounter``: the weights it gathers,
  the caches it gathers and copies, saved activations, gradients,
  temporaries; traced at ``PEAK_UNITS`` and extrapolated, see there),
  and ``working_set_bytes`` the two summed: what a device must hold,
  which the placements alone understate.  With full attention in the
  trace (below) a train or prefill cell's peak holds n x n scores that
  the flash never does.  XLA's ``temp_size`` and
  ``generated_code_size`` have no counterpart here
  (``memory["no_counterpart"]`` names them).
* ``collectives``: ``count_collectives``, the twin of
  ``parse_collectives``: every c10d or functional collective the trace
  dispatches, read with its operand shape and group size by a dispatch
  mode, summed per kind with the same ring model of wire bytes a device.
* ``cost``: one device's FLOPs (``FlopCounterMode`` over the local
  shards the step computes on, products only; a DTensor product would
  count the global one) and ``bytes accessed`` (``BytesCounter``: every
  non-view op's inputs and outputs, XLA's measure).

Tracing a 48-layer step at 32k through the flash's block loops would
not end in any sane time, so the step is traced at one and at two
layer-units with ``REPRO_FORCE_FULL_ATTENTION`` (the same products, no
block loops) and extrapolated to the full depth, as the reference's
``benchmarks/hlo_cost.py`` does: ``cost(L) = cost(1u) + (units - 1) *
(cost(2u) - cost(1u))``.  The output says so (``"traced_units"``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape all --both-meshes [--out dryrun.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree as T
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.core.mesh import CollectiveCounter, count_collectives  # noqa: F401
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.params import NamedSharding, contiguous_stride

class BytesCounter(TorchDispatchMode):
    """While active, the bytes every non-view op reads and writes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and "c10d" not in str(func):
            for x in list(args) + list((kwargs or {}).values()) + (
                    list(out) if isinstance(out, (tuple, list)) else [out]):
                if isinstance(x, torch.Tensor):
                    self.total += x.numel() * x.element_size()
        return out


class PeakCounter(TorchDispatchMode):
    """While active, the bytes of the storages the dispatched ops create
    that are still alive, and their peak: the step's transient working
    set (gathered weights, activations saved for the backward,
    gradients, temporaries) above the arguments it was handed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


# per-cell gradient-accumulation overrides (the reference's): biggest
# models need microbatching to fit 16 GB/chip at global batch 256.
MICRO_OVERRIDES = {
    ("llama4-scout-17b-a16e", "train_4k"): 4,
    ("gemma2-27b", "train_4k"): 2,
    ("qwen3-moe-30b-a3b", "train_4k"): 2,
    ("whisper-tiny", "train_4k"): 8,
    ("mamba2-370m", "train_4k"): 8,
    ("zamba2-2.7b", "train_4k"): 32,
}


# ------------------------------------------------------------- layer units

def unit_layers(cfg) -> int:
    """The smallest repeating block: 1 layer; gemma2's local/global pair;
    zamba2's ``attn_every`` mamba layers and the shared attention."""
    if cfg.family == "hybrid":
        return max(cfg.attn_every, 1)
    if cfg.local_global_pattern:
        return 2
    return 1


def n_units(cfg) -> int:
    return cfg.n_layers // unit_layers(cfg)


def cfg_at_units(cfg, units: int):
    kw = dict(n_layers=units * unit_layers(cfg))
    if cfg.family == "encdec":
        enc_per_unit = max(cfg.n_enc_layers // max(n_units(cfg), 1), 1)
        kw["n_enc_layers"] = units * enc_per_unit
    return cfg.replace(**kw)


def extrapolate(c1: float, c2: float, units: int) -> float:
    return c1 + (units - 1) * max(c2 - c1, 0.0)


# ----------------------------------------------------------------- memory

def _dev_bytes(abstract, sharding) -> int:
    if sharding is None:
        return abstract.numel() * abstract.element_size()
    return sharding.shard_bytes(abstract)


def _tree_bytes(abstract, shardings) -> int:
    return sum(_dev_bytes(a, s) for a, s in zip(
        T.leaves(abstract), T.leaves(shardings)))


def device_bytes(cfg, shape, mesh, micro_steps: int = 1) -> dict:
    """Each device's bytes of the step's arguments, by kind, from the
    placements ``make_step`` gives them (``mesh`` may be an
    ``AbstractMesh``: only names and sizes are read)."""
    from repro_torch.train.train_step import make_step
    _, in_sh, _, args = make_step(cfg, shape, mesh, micro_steps=micro_steps)
    if shape.kind == "train":
        out = {"param_bytes": _tree_bytes(args[0], in_sh[0]),
               "opt_bytes": _tree_bytes(args[1], in_sh[1]),
               "cache_bytes": 0,
               "input_bytes": _tree_bytes(args[2], in_sh[2])}
    elif shape.kind == "prefill":
        out = {"param_bytes": _tree_bytes(args[0], in_sh[0]), "opt_bytes": 0,
               "cache_bytes": 0,
               "input_bytes": _tree_bytes(args[1], in_sh[1])}
    else:
        out = {"param_bytes": _tree_bytes(args[0], in_sh[0]), "opt_bytes": 0,
               "cache_bytes": _tree_bytes(args[1], in_sh[1]),
               "input_bytes": (_dev_bytes(args[2], in_sh[2])
                               + _dev_bytes(args[3], in_sh[3]))}
    out["argument_size_bytes"] = sum(out.values())
    return out


def cell_specs(cfg, shape, mesh, micro_steps: int = 1) -> dict:
    """Every argument's partition spec, flattened to ``"path": spec`` (the
    reference's ``in_shardings`` read as ``P(...)`` tuples)."""
    from repro_torch.train.train_step import make_step
    _, in_sh, _, _ = make_step(cfg, shape, mesh, micro_steps=micro_steps)
    out = {}

    def walk(node, path):
        if isinstance(node, NamedSharding):
            out[path] = [list(e) if isinstance(e, tuple) else e
                         for e in node.spec]
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (tuple, list)):
            for i, c in enumerate(node):
                walk(c, f"{path}/{i}")
    walk(in_sh, "")
    return out


# ----------------------------------------------------------------- tracing

def _fake_dtensor(abstract, sharding):
    """A DTensor of ``abstract``'s global shape placed by ``sharding``,
    its local shard a fake tensor."""
    from torch.distributed.tensor import DTensor
    shape = tuple(abstract.shape)
    if shape == ():
        local = torch.zeros((), dtype=abstract.dtype)
    else:
        local = torch.zeros(sharding.local_shape(shape), dtype=abstract.dtype)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _fake_args(args, shardings):
    return T.tree_map(_fake_dtensor, args, shardings)


def trace_cost(cfg, shape, mesh, micro_steps: int = 1, *,
               peak_only: bool = False) -> dict:
    """One call of the cell's meshed step on fake tensors: its
    collectives, one device's FLOPs, bytes accessed and peak transient
    bytes (``peak_only``: the peak alone)."""
    from contextlib import ExitStack

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.train_step import make_step
    fn, in_sh, _, args = make_step(cfg, shape, mesh, micro_steps=micro_steps)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tuple(_fake_args(a, s) for a, s in zip(args, in_sh))
        if shape.kind == "decode":
            fake = (fake[0], tuple(fake[1]), fake[2], fake[3])
        with ExitStack() as stack:
            if not peak_only:
                cc = stack.enter_context(CollectiveCounter())
                flops = stack.enter_context(FlopCounterMode(display=False))
                bc = stack.enter_context(BytesCounter())
            pc = stack.enter_context(PeakCounter())
            fn(*fake)
    if peak_only:
        return {"peak": float(pc.peak)}
    return {"flops": float(flops.get_total_flops()), "bytes": float(bc.total),
            "peak": float(pc.peak), "collectives": cc.summary()}


# the peak is a maximum, not a sum: at one or two layer-units it can fall
# at another moment of the step than at full depth (the weights' gather
# against the caches' copies), so it is traced at these two depths, past
# that switch, and extrapolated from them (or traced at full depth where
# that is no deeper)
PEAK_UNITS = (4, 5)


def trace_peak(cfg, shape, mesh, micro_steps: int = 1) -> tuple:
    """(the cell's peak transient bytes at full depth, the units traced)."""
    units, (a, b) = n_units(cfg), PEAK_UNITS
    if units <= b:
        return trace_cost(cfg, shape, mesh, micro_steps,
                          peak_only=True)["peak"], [units]
    pa, pb = (trace_cost(cfg_at_units(cfg, u), shape, mesh, micro_steps,
                         peak_only=True)["peak"] for u in (a, b))
    return pb + (units - b) * max(pb - pa, 0.0), [a, b]


def run_cell(arch: str, shape_id: str, multi_pod: bool,
             micro_steps: int = 0) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    n_dev = 512 if multi_pod else 256
    fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    micro = micro_steps or MICRO_OVERRIDES.get((arch, shape_id), 1)
    t0 = time.time()
    mem = device_bytes(cfg, shape, mesh, micro)
    units = n_units(cfg)
    old = os.environ.get("REPRO_FORCE_FULL_ATTENTION")
    os.environ["REPRO_FORCE_FULL_ATTENTION"] = "1"
    try:
        c1 = trace_cost(cfg_at_units(cfg, 1), shape, mesh, micro)
        c2 = (trace_cost(cfg_at_units(cfg, 2), shape, mesh, micro)
              if units > 1 else c1)
        peak, peak_units = trace_peak(cfg, shape, mesh, micro)
    finally:
        if old is None:
            os.environ.pop("REPRO_FORCE_FULL_ATTENTION")
        else:
            os.environ["REPRO_FORCE_FULL_ATTENTION"] = old
    coll1, coll2 = c1["collectives"], c2["collectives"]
    kinds = sorted(set(coll1["operand_bytes_by_kind"])
                   | set(coll2["operand_bytes_by_kind"]))
    by_kind = {k: extrapolate(coll1["operand_bytes_by_kind"].get(k, 0.0),
                              coll2["operand_bytes_by_kind"].get(k, 0.0),
                              units) for k in kinds}
    collectives = {
        "operand_bytes_by_kind": by_kind,
        "operand_bytes_total": sum(by_kind.values()),
        "wire_bytes_per_device": extrapolate(
            coll1["wire_bytes_per_device"], coll2["wire_bytes_per_device"],
            units),
        "n_collectives": int(extrapolate(coll1["n_collectives"],
                                         coll2["n_collectives"], units))}
    trace_s = time.time() - t0
    return {"arch": arch, "shape": shape_id, "mesh": mesh_name,
            "status": "ok", "trace_s": round(trace_s, 1),
            "micro_steps": micro, "n_devices": n_dev,
            "n_params": int(cfg.param_count()),
            "n_params_active": int(cfg.param_count(active_only=True)),
            "model_flops": M.model_flops(cfg, shape),
            "memory": {**mem, "peak_transient_bytes": peak,
                       "working_set_bytes": mem["argument_size_bytes"] + peak,
                       "temp_size_bytes": None,
                       "generated_code_size_bytes": None,
                       "no_counterpart": ["temp_size_bytes",
                                          "generated_code_size_bytes"]},
            "cost": {"flops": extrapolate(c1["flops"], c2["flops"], units),
                     "bytes accessed": extrapolate(c1["bytes"], c2["bytes"],
                                                   units)},
            "collectives": collectives,
            "traced_units": {"units": units, "unit_layers": unit_layers(cfg),
                             "traced": [1, 2] if units > 1 else [1],
                             "peak_traced": peak_units,
                             "attention": "full (REPRO_FORCE_FULL_ATTENTION)"}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    n_err = 0
    for arch in archs:
        for shape_id in shapes:
            for mp in meshes:
                key = (arch, shape_id, "multi" if mp else "single")
                if key in done:
                    print(f"[skip-done] {key}", flush=True)
                    continue
                print(f"[run] {key}", flush=True)
                try:
                    res = run_cell(arch, shape_id, mp)
                except Exception as e:  # a cell's failure is its record
                    res = {"arch": arch, "shape": shape_id,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    n_err += 1
                line = json.dumps(res)
                print(f"[res] {res['status']} {key} "
                      f"trace={res.get('trace_s', '-')}s", flush=True)
                if res["status"] == "error":
                    print(res["traceback"], flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
                else:
                    print(line, flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())

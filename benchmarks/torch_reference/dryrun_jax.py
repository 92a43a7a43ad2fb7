"""The JAX package's side of ``benchmarks/torch_dryrun_reference.py``
(which runs this file in a subprocess; run it through that module):

    python benchmarks/torch_reference/dryrun_jax.py <all|arch,arch> <0|1>

prints one line ``JSON {...}``: each cell's partition specs and
per-device argument bytes by kind from ``repro.train.train_step.
make_step``'s shardings on an ``AbstractMesh``; with ``1``, also the
compiled decode cells' ``argument_size_bytes`` and the twelve
``repro.launch.dryrun_dhnsw`` rows.
"""
import json
import os
import sys

# the compiled cells need 512 host devices, fixed at jax's first init
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro.launch import dryrun as RD  # noqa: E402
from repro.launch import dryrun_dhnsw as RH  # noqa: E402
from repro.train.train_step import make_step  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
archs = ARCH_IDS if sys.argv[1] == "all" else sys.argv[1].split(",")
full = sys.argv[2] == "1"


def walk(node, path, out):
    if isinstance(node, NamedSharding):
        out[path] = node
    elif isinstance(node, dict):
        for k in sorted(node):
            walk(node[k], f"{path}/{k}", out)
    elif isinstance(node, (tuple, list)):
        for i, c in enumerate(node):
            walk(c, f"{path}/{i}", out)


def nbytes(a, sh):
    return int(np.prod(sh.shard_shape(a.shape), dtype=np.int64)
               * np.dtype(a.dtype).itemsize)


def tree_bytes(args, shs):
    s = {}
    walk(shs, "", s)
    leaves = jax.tree.leaves(args)
    flat = [s[k] for k in s]
    assert len(leaves) == len(flat), (len(leaves), len(flat))
    return sum(nbytes(x, sh) for x, sh in zip(leaves, flat))


cells = {}
for arch in archs:
    cfg = get_config(arch)
    for sid, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        for mname, (sizes, names) in MESHES.items():
            mesh = AbstractMesh(sizes, names)
            micro = RD.MICRO_OVERRIDES.get((arch, sid), 1)
            _, in_sh, _, args = make_step(cfg, shape, mesh, micro_steps=micro)
            specs = {}
            walk(in_sh, "", specs)
            if shape.kind == "train":
                mem = {"param_bytes": tree_bytes(args[0], in_sh[0]),
                       "opt_bytes": tree_bytes(args[1], in_sh[1]),
                       "cache_bytes": 0,
                       "input_bytes": tree_bytes(args[2], in_sh[2])}
            elif shape.kind == "prefill":
                mem = {"param_bytes": tree_bytes(args[0], in_sh[0]),
                       "opt_bytes": 0, "cache_bytes": 0,
                       "input_bytes": tree_bytes(args[1], in_sh[1])}
            else:
                mem = {"param_bytes": tree_bytes(args[0], in_sh[0]),
                       "opt_bytes": 0,
                       "cache_bytes": tree_bytes(args[1], in_sh[1]),
                       "input_bytes": nbytes(args[2], in_sh[2])
                                      + nbytes(args[3], in_sh[3])}
            mem["argument_size_bytes"] = sum(mem.values())
            cell = {"memory": mem,
                    "specs": {k: [list(e) if isinstance(e, tuple) else e
                                  for e in v.spec]
                              for k, v in specs.items()}}
            if full and shape.kind == "decode":
                r = RD.run_cell(arch, sid, mname == "multi")
                cell["compiled_argument_size_bytes"] = r["memory"][
                    "argument_size_bytes"]
            cells[f"{arch}|{sid}|{mname}"] = cell
dhnsw = []
if full:
    for mp in (False, True):
        for v in ("baseline", "sharded", "quantized", "int8_rest",
                  "span_dma", "bf16_serve"):
            r = RH.run(v, mp)
            dhnsw.append({k: r[k] for k in ("cell", "mesh", "coll_kinds",
                                            "wire_dev", "n_collectives",
                                            "arg_bytes")})
print("JSON " + json.dumps({"cells": cells, "dhnsw": dhnsw}))

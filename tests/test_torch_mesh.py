"""The port's mesh machinery against the JAX package's, with no ranks:
the logical specs of every (arch x shape x mesh) cell and each device's
bytes of parameters, optimizer state, cache and inputs, resolved on the
production (16, 16) and (2, 16, 16) meshes as ``AbstractMesh``es (names
and sizes, no devices), as the reference's ``resolve_spec``,
``param_shardings`` and ``cache_logical_spec`` need only those; the
serving defs, the inputs' and caches' logical specs, the abstract
params and optimizer state, the counts of parameters and model FLOPs;
and the local shard offsets of a multi-pod spec against JAX's."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.train import adamw as JA  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import tree as TT  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.train import adamw as TA  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jwalk(node, path, out):
    if isinstance(node, JNamedSharding):
        out[path] = node
    elif isinstance(node, dict):
        for k in sorted(node):
            _jwalk(node[k], f"{path}/{k}", out)
    elif isinstance(node, (tuple, list)):
        for i, c in enumerate(node):
            _jwalk(c, f"{path}/{i}", out)


def _jbytes(args, shs) -> int:
    flat = {}
    _jwalk(shs, "", flat)
    leaves = jax.tree.leaves(args)
    assert len(leaves) == len(flat)
    return sum(int(np.prod(sh.shard_shape(a.shape), dtype=np.int64))
               * np.dtype(a.dtype).itemsize
               for a, sh in zip(leaves, flat.values()))


def reference_cell(arch, sid, mname):
    """(specs, bytes by kind) of the reference's ``make_step`` shardings."""
    cfg, shape = JR.get_config(arch), JSHAPES[sid]
    mesh = JAbstractMesh(*MESHES[mname])
    micro = JD.MICRO_OVERRIDES.get((arch, sid), 1)
    _, in_sh, _, args = JTS.make_step(cfg, shape, mesh, micro_steps=micro)
    flat = {}
    _jwalk(in_sh, "", flat)
    specs = {k: [list(e) if isinstance(e, tuple) else e for e in v.spec]
             for k, v in flat.items()}
    if shape.kind == "train":
        mem = {"param_bytes": _jbytes(args[0], in_sh[0]),
               "opt_bytes": _jbytes(args[1], in_sh[1]), "cache_bytes": 0,
               "input_bytes": _jbytes(args[2], in_sh[2])}
    elif shape.kind == "prefill":
        mem = {"param_bytes": _jbytes(args[0], in_sh[0]), "opt_bytes": 0,
               "cache_bytes": 0, "input_bytes": _jbytes(args[1], in_sh[1])}
    else:
        mem = {"param_bytes": _jbytes(args[0], in_sh[0]), "opt_bytes": 0,
               "cache_bytes": _jbytes(args[1], in_sh[1]),
               "input_bytes": _jbytes((args[2], args[3]),
                                      (in_sh[2], in_sh[3]))}
    mem["argument_size_bytes"] = sum(mem.values())
    return specs, mem


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
def test_specs_and_device_bytes(arch):
    """Every cell's partition specs and per-device bytes by kind equal the
    reference's on both production meshes."""
    cfg = TR.get_config(arch)
    for sid, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        micro = TD.MICRO_OVERRIDES.get((arch, sid), 1)
        for mname, (sizes, names) in MESHES.items():
            mesh = TP.AbstractMesh(sizes, names)
            want_specs, want_mem = reference_cell(arch, sid, mname)
            got_specs = TD.cell_specs(cfg, shape, mesh, micro)
            assert got_specs == want_specs, (arch, sid, mname)
            assert TD.device_bytes(cfg, shape, mesh, micro) == want_mem, (
                arch, sid, mname)


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
def test_resolve_spec_reads_as_partition_spec(arch):
    """``resolve_spec`` of every serving and training leaf is the
    reference's ``PartitionSpec`` read as a tuple, trailing Nones gone."""
    for mname, (sizes, names) in MESHES.items():
        tmesh, jmesh = TP.AbstractMesh(sizes, names), JAbstractMesh(sizes,
                                                                      names)
        for tdefs, jdefs in ((TM.param_defs(TR.get_config(arch)),
                              JM.param_defs(JR.get_config(arch))),
                             (TM.serve_param_defs(TR.get_config(arch)),
                              JM.serve_param_defs(JR.get_config(arch)))):
            got = TP.param_pspecs(tdefs, tmesh)
            want = JP.param_pspecs(jdefs, jmesh)
            flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                x, TP.P))
            flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            assert [tuple(g) for g in flat_g] == [tuple(w) for w in flat_w]
            assert all(not g or g[-1] is not None for g in flat_g)


def _defs_equal(tdefs, jdefs, dtype_map):
    tl = list(TP._leaves(tdefs))
    jl = jax.tree.leaves_with_path(jdefs, is_leaf=lambda x: isinstance(
        x, JP.ParamDef))
    assert len(tl) == len(jl)
    for (path, td), (_, jd) in zip(tl, jl):
        assert (td.shape, td.logical, td.init, td.scale) == (
            jd.shape, jd.logical, jd.init, jd.scale), path
        assert td.dtype == dtype_map[np.dtype(jd.dtype).name], path


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
def test_serve_defs_inputs_and_caches(arch):
    """``serve_param_defs`` (bf16, fsdp dropped), ``input_logical_specs``
    of each shape, each family's ``cache_logical_spec`` at tp 1, 8 and
    16, ``abstract_params`` and ``abstract_state``."""
    tcfg, jcfg = TR.get_config(arch), JR.get_config(arch)
    _defs_equal(TM.serve_param_defs(tcfg), JM.serve_param_defs(jcfg),
                {"bfloat16": torch.bfloat16})
    for sid, shape in SHAPES.items():
        assert TM.input_logical_specs(tcfg, shape) == \
            JM.input_logical_specs(jcfg, JSHAPES[sid])
    for tp in (1, 8, 16):
        assert TM.cache_logical_spec(tcfg, tp) == JM.cache_logical_spec(
            jcfg, tp)
    tabs = TP.abstract_params(TM.param_defs(tcfg))
    jabs = JP.abstract_params(JM.param_defs(jcfg))
    topt, jopt = TA.abstract_state(tabs), JA.abstract_state(jabs)
    for t, j in ((tabs, jabs), (topt, jopt)):
        tl = TT.leaves(t)
        jl = jax.tree.leaves(j)
        assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
        assert [str(x.dtype).replace("torch.", "") for x in tl] == [
            np.dtype(x.dtype).name for x in jl]
        assert all(x.device.type == "meta" for x in tl)


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
def test_param_counts_and_model_flops(arch):
    tcfg, jcfg = TR.get_config(arch), JR.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.param_count(active_only=True) == jcfg.param_count(
        active_only=True)
    assert TP.count_params(TM.param_defs(tcfg)) == JP.count_params(
        JM.param_defs(jcfg))
    for sid, shape in SHAPES.items():
        assert TM.model_flops(tcfg, shape) == JM.model_flops(jcfg,
                                                             JSHAPES[sid])


OFFSETS = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.array(jax.devices()).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
sh = NamedSharding(mesh, P(("pod", "data"), "model"))
idx = sh.devices_indices_map((8, 6))
out = {}
for c in np.ndindex(2, 2, 2):
    s = idx[devs[c]]
    out[",".join(map(str, c))] = [[x.start or 0, x.stop] for x in s]
print(json.dumps(out))
"""


class _At(TP.AbstractMesh):
    """An abstract mesh seen from the rank at ``coords``."""

    def __init__(self, shape, names, coords):
        super().__init__(shape, names)
        object.__setattr__(self, "coords", coords)

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


def test_multi_pod_local_offsets_match_jax():
    """A dim sharded over ("pod", "data"): each rank's shard from
    ``local_part`` sits where JAX puts it (pod the major axis), and the
    placements are ``Shard(0)`` on both axes."""
    out = subprocess.run([sys.executable, "-c", OFFSETS], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    want = json.loads(out.stdout.strip().splitlines()[-1])
    full = torch.arange(48).reshape(8, 6)
    spec = TP.P(("pod", "data"), "model")
    for key, sl in want.items():
        coords = tuple(int(c) for c in key.split(","))
        mesh = _At((2, 2, 2), ("pod", "data", "model"), coords)
        part = TP.local_part(full, TP.NamedSharding(mesh, spec))
        assert torch.equal(part, full[sl[0][0]:sl[0][1], sl[1][0]:sl[1][1]])
    from torch.distributed.tensor import Shard
    assert TP.placements(spec, TP.AbstractMesh((2, 2, 2), (
        "pod", "data", "model"))) == [Shard(0), Shard(0), Shard(1)]

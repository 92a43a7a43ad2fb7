"""The port's dry runs (``repro_torch.launch.dryrun`` and
``dryrun_dhnsw``) on the fake backend, one process playing every rank:
the smoke configs' meshed steps traced on a fake (2, 4) mesh with each
device's bytes equal to the reference's specs; the twelve d-HNSW rows'
collectives equal to the committed reference
(``benchmarks/torch_reference/dryrun.json``); a subset of that file
regenerated from the JAX package; the fetch's collectives against the
reference's compiled ``abstract_fetch_lowered`` (one all-reduce where it
has two, the same operand bytes); and a production cell's argument
bytes against the reference's compiled ``argument_size_bytes``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:            # the benchmarks package
    sys.path.insert(0, ROOT)
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from benchmarks import torch_dryrun_reference as REF  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.layout import build_store  # noqa: E402
from repro_torch.core.meta import build_meta  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import dryrun_dhnsw as TH  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.models.params import AbstractMesh  # noqa: E402
from test_torch_mesh import _jbytes  # noqa: E402

SMALL = {"train": InputShape("t", 64, 8, "train"),
         "prefill": InputShape("p", 64, 8, "prefill"),
         "decode": InputShape("d", 64, 8, "decode")}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake backend for 8 ranks for this module, gone after it."""
    fake_world(8)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_bytes(arch, shape) -> int:
    """Each device's bytes of all the reference's step arguments on an
    abstract (2, 4) mesh."""
    from repro.configs.base import InputShape as JShape
    _, in_sh, _, args = JTS.make_step(
        JR.smoke_config(arch), JShape(shape.name, shape.seq_len,
                                      shape.global_batch, shape.kind),
        JAbstractMesh((2, 4), ("data", "model")))
    return _jbytes(args, in_sh)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e", "zamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_dry_run_on_fake_mesh(arch, kind):
    """A smoke config's meshed step traced on a fake (2, 4) mesh: each
    device's argument bytes equal the reference's specs on the same
    mesh, it runs collectives, and a device's FLOPs are below the
    unsharded step's."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg, shape = smoke_config(arch), SMALL[kind]
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mem = TD.device_bytes(cfg, shape, mesh)
    assert mem["argument_size_bytes"] == _reference_bytes(arch, shape)
    cost = TD.trace_cost(cfg, shape, mesh)
    coll = cost["collectives"]
    assert coll["n_collectives"] > 0 and coll["wire_bytes_per_device"] > 0
    assert set(coll["operand_bytes_by_kind"]) <= {
        "all-reduce", "all-gather", "reduce-scatter"}
    one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    whole = TD.trace_cost(cfg, shape, one)
    assert whole["collectives"]["n_collectives"] == 0
    assert 0 < cost["flops"] < whole["flops"]


# each family's smoke config: a (2, 4) mesh's products, summed over its 8
# devices, over the unmeshed step's (FlopCounterMode), as read on the CPU
# when the meshed steps came to split their work over ``model``.  What is
# left above 1: the kv head that tp / K = 2 ranks share, whose k and v
# both compute at train and prefill; the router and B/C projections
# (replicated, as placed); at decode the moe capacity's floor of 4 slots
# an expert on each data shard (the reference's ``_capacity``).
MESH_PRODUCTS = {
    ("qwen3-8b", "train"): 1.083, ("qwen3-8b", "prefill"): 1.091,
    ("qwen3-8b", "decode"): 1.000,
    ("qwen3-moe-30b-a3b", "train"): 1.084,
    ("qwen3-moe-30b-a3b", "prefill"): 1.094,
    ("qwen3-moe-30b-a3b", "decode"): 1.322,
    ("pixtral-12b", "train"): 1.087, ("pixtral-12b", "prefill"): 1.097,
    ("pixtral-12b", "decode"): 1.000,
    ("mamba2-370m", "train"): 1.130, ("mamba2-370m", "prefill"): 1.129,
    ("mamba2-370m", "decode"): 1.185,
    ("zamba2-2.7b", "train"): 1.119, ("zamba2-2.7b", "prefill"): 1.117,
    ("zamba2-2.7b", "decode"): 1.110,
    ("whisper-tiny", "train"): 1.102, ("whisper-tiny", "prefill"): 1.110,
    ("whisper-tiny", "decode"): 1.000}


@pytest.mark.parametrize("arch,kind", list(MESH_PRODUCTS))
def test_meshed_step_splits_its_products(arch, kind):
    """Every family's meshed step splits its work over ``model``: on the
    fake (2, 4) mesh the products a device, summed over the mesh, are at
    most 1.5x the unmeshed step's, and at most 2 % above the reading in
    ``MESH_PRODUCTS`` (a weight gathered whole again and its product run
    on every rank shows there first: qwen3-8b's ``wq`` alone moves its
    prefill from 1.09 to 1.36).  A decode cell's working set is at most
    twice its placed arguments (it attends its cache where it lies)."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg, shape = smoke_config(arch), SMALL[kind]
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cost = TD.trace_cost(cfg, shape, mesh)
    ratio = 8 * cost["flops"] / TD.trace_cost(cfg, shape, one)["flops"]
    print(arch, kind, f"{ratio:.3f}")
    assert ratio <= 1.5
    assert ratio <= 1.02 * MESH_PRODUCTS[arch, kind]
    if kind == "decode":
        args = TD.device_bytes(cfg, shape, mesh)["argument_size_bytes"]
        assert args + cost["peak"] <= 2 * args


def test_dhnsw_rows_equal_reference():
    """The twelve d-HNSW rows: per-device collective operand and wire
    bytes, the collective count and the argument bytes equal the
    reference's (e.g. baseline single: one all-reduce of 25 165 824 B,
    47 185 920 B on the wire)."""
    want = {(r["cell"], r["mesh"]): r for r in REF.load()["dhnsw"]}
    assert len(want) == 12
    for mp in (False, True):
        for v in TH.VARIANTS:
            got = TH.run(v, mp)
            ref = want[(got["cell"], got["mesh"])]
            for k in REF.DHNSW_FIELDS:
                assert got[k] == ref[k], (v, mp, k)
    fake_world(8)
    base = want[("dhnsw-serve/baseline", "single")]
    assert base["coll_kinds"] == {"all-reduce": 25165824.0}
    assert base["wire_dev"] == 47185920.0


def test_reference_file_regenerates():
    """qwen3-8b's cells regenerated from the JAX package equal the
    committed file's."""
    got = REF.generate("qwen3-8b", full=False)["cells"]
    want = REF.load()["cells"]
    assert len(got) == 6        # 3 shapes (no long_500k) x 2 meshes
    for k, v in got.items():
        assert {f: want[k][f] for f in v} == v, k


# the arguments a compiled decode cell never reads, which XLA drops from
# its argument_size_bytes (param leaves by path, or "pos")
UNREAD = {"pixtral-12b": ("/patch_proj",),
          "whisper-tiny": ("/enc_blocks/", "/enc_norm", "/dec_blocks/x_wk",
                           "/dec_blocks/x_wv"),
          "mamba2-370m": ("pos",)}


def _unread_bytes(arch, shape, mesh) -> int:
    from repro_torch.configs.registry import get_config
    from repro_torch.train.train_step import make_step
    _, in_sh, _, args = make_step(get_config(arch), shape, mesh)
    if UNREAD.get(arch) == ("pos",):
        return in_sh[3].shard_bytes(args[3])
    out = []

    def walk(a, s, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k], f"{path}/{k}")
        elif any(path.startswith(u) for u in UNREAD.get(arch, ())):
            out.append(s.shard_bytes(a))
    walk(args[0], in_sh[0])
    return sum(out)


def test_compiled_decode_argument_bytes():
    """Every decode cell: each device's argument bytes from the
    placements equal the reference's compiled ``argument_size_bytes``
    (3 440 339 008 for qwen3-8b single) less exactly the arguments the
    decode never reads, which XLA drops (``UNREAD``); every cell's bytes
    by kind equal the file's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.base import SHAPES
    ref = REF.load()["cells"]
    meshes = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
    assert ref["qwen3-8b|decode_32k|single"][
        "compiled_argument_size_bytes"] == 3440339008
    for key, cell in ref.items():
        arch, sid, m = key.split("|")
        mem = TD.device_bytes(get_config(arch), SHAPES[sid],
                              AbstractMesh(*meshes[m]),
                              TD.MICRO_OVERRIDES.get((arch, sid), 1))
        assert mem == cell["memory"], key
        if "compiled_argument_size_bytes" in cell:
            unread = _unread_bytes(arch, SHAPES[sid],
                                   AbstractMesh(*meshes[m]))
            assert (unread > 0) == (arch in UNREAD)
            assert mem["argument_size_bytes"] - unread == cell[
                "compiled_argument_size_bytes"], key


FETCH_REF = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.core.distributed import abstract_fetch_lowered
from repro.core.layout import LayoutSpec, Store
from repro.launch.dryrun import parse_collectives
a = np.load(sys.argv[1])
store = Store(spec=LayoutSpec(**{k[5:]: int(a[k]) for k in a.files
                                 if k.startswith("spec_")}),
              graph_buf=a["graph_buf"], vec_buf=a["vec_buf"],
              meta_table=a["meta_table"], n_base=a["n_base"])
mesh = jax.make_mesh((2, 4), ("data", "model"))
_, compiled = abstract_fetch_lowered(store, mesh, 16)
print("JSON " + json.dumps(parse_collectives(compiled.as_text())))
"""


def test_abstract_fetch_counts(tmp_path):
    """The port's fetch is one all-reduce where the reference's compiled
    fetch has two (graph rows and vector rows apart); the operand bytes
    are equal."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.core.distributed import abstract_fetch_counted
    ds = sift_like(n=1500, n_queries=4, seed=1)
    store = build_store(ds.data, build_meta(ds.data, 12, seed=0))
    np.savez(tmp_path / "store.npz", graph_buf=store.graph_buf,
             vec_buf=store.vec_buf, meta_table=store.meta_table,
             n_base=store.n_base, **{f"spec_{f}": int(getattr(store.spec, f))
                                     for f in convert.SPEC_FIELDS})
    out = subprocess.run([sys.executable, "-c", FETCH_REF,
                          str(tmp_path / "store.npz")], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(next(line for line in out.stdout.splitlines()
                           if line.startswith("JSON "))[5:])
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    got = abstract_fetch_counted(store, mesh, 16)
    assert want["n_collectives"] == 2 and got["n_collectives"] == 1
    assert got["operand_bytes_total"] == want["operand_bytes_total"]
    assert got["wire_bytes_per_device"] == want["wire_bytes_per_device"]


def test_cli_and_roofline(tmp_path):
    """``python -m repro_torch.launch.dryrun``'s CLI for one production
    cell (the reference's JSONL keys), and the roofline twin over it."""
    from benchmarks import torch_roofline
    out = tmp_path / "dryrun.jsonl"
    assert TD.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                    "--out", str(out)]) == 0
    fake_world(8)
    r = json.loads(out.read_text().splitlines()[0])
    for k in ("arch", "shape", "mesh", "status", "micro_steps", "n_devices",
              "n_params", "n_params_active", "model_flops", "memory", "cost",
              "collectives"):
        assert k in r
    assert r["memory"]["argument_size_bytes"] == 3440339008
    assert r["memory"]["no_counterpart"] == ["temp_size_bytes",
                                             "generated_code_size_bytes"]
    # the decode attends its cache where it lies: the working set stays
    # within twice the arguments (it was 86.94 GB when the cache was
    # gathered over model)
    assert r["memory"]["working_set_bytes"] == (
        r["memory"]["argument_size_bytes"]
        + r["memory"]["peak_transient_bytes"])
    assert 0 < r["memory"]["peak_transient_bytes"] < r["memory"][
        "cache_bytes"]
    assert r["memory"]["working_set_bytes"] <= 2 * r["memory"][
        "argument_size_bytes"]
    rows = torch_roofline.run(str(out))
    assert [x["name"] for x in rows] == [
        "roofline/qwen3-8b/decode_32k/single"]
    assert rows[0]["dominant"] in ("compute", "memory", "collective")


def test_working_set_counts_what_the_step_gathers():
    """``PeakCounter`` sees the copies a meshed step makes on top of its
    arguments and not the arguments themselves: the decode takes its
    cache where it lies (its peak below the cache gathered over the 4
    model ranks, which it was above when it gathered it), the train step
    gathers every f32 weight over ``data`` and keeps its ``model`` shard
    (the working copies, whole on each rank where ``_keeps`` keeps no
    ``model``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree as T
    from repro_torch.models import model as TM
    from repro_torch.models.params import (NamedSharding, P,
                                           param_shardings)
    from repro_torch.train import train_step as TTS
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = smoke_config("qwen3-8b")
    mem = TD.device_bytes(cfg, SMALL["decode"], mesh)
    assert TD.trace_cost(cfg, SMALL["decode"], mesh)["peak"] < (
        4 * mem["cache_bytes"])
    defs = TM.param_defs(cfg)
    keeps = TTS._keeps(cfg, defs, mesh)
    working = sum(NamedSharding(mesh, P(*(
        e if e == "model" and "model" in keep else None
        for e in sh.spec))).shard_bytes(d.abstract())
        for d, sh, keep in zip(T.leaves(defs),
                               T.leaves(param_shardings(defs, mesh)),
                               T.leaves(keeps)))
    assert working > TD.device_bytes(cfg, SMALL["train"], mesh)["param_bytes"]
    assert TD.trace_cost(cfg, SMALL["train"], mesh)["peak"] >= working


def test_peak_extrapolation_matches_full_depth():
    """The peak traced at ``PEAK_UNITS`` and extrapolated equals the peak
    of the whole 36-layer step traced at once (qwen3-8b decode_32k on the
    single production mesh, a few seconds).  The decode holds nothing
    that grows with its depth (its cache is attended where it lies, no
    gather of it), so the peak is one layer's and one and two units
    give it too."""
    from repro_torch.configs.registry import get_config, get_shape
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        cfg, shape = get_config("qwen3-8b"), get_shape("decode_32k")
        os.environ["REPRO_FORCE_FULL_ATTENTION"] = "1"
        try:
            peak, units = TD.trace_peak(cfg, shape, mesh)
            full = TD.trace_cost(cfg, shape, mesh, peak_only=True)["peak"]
            p1, p2 = (TD.trace_cost(TD.cfg_at_units(cfg, u), shape, mesh,
                                    peak_only=True)["peak"] for u in (1, 2))
        finally:
            os.environ.pop("REPRO_FORCE_FULL_ATTENTION")
    finally:
        fake_world(8)
    assert units == list(TD.PEAK_UNITS)
    assert peak == full
    assert p1 == p2 == full


@pytest.mark.parametrize("arch", ["qwen3-8b", "pixtral-12b"])
def test_sequence_parallel_saves_the_layer_inputs(arch, monkeypatch):
    """Sequence parallelism keeps each layer's saved input as this rank's
    S/tp shard: on the fake (2, 4) mesh a smoke train cell's peak
    transient falls, with every layer added, by one layer input's
    (tp - 1)/tp (B_loc S d bytes (tp - 1)/tp, S counting pixtral's
    patches) against the step with sequence parallelism off, within one
    layer's gathered input (B_loc S d bytes); at each depth the fall is
    at least L such shares (the layer's own transient shrinks too: its
    residual-stream tensors are shards)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import transformer as TF
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    shape, tp = SMALL["train"], 4

    def fall(L):
        cfg = smoke_config(arch).replace(n_layers=L)
        on = TD.trace_cost(cfg, shape, mesh, peak_only=True)["peak"]
        with monkeypatch.context() as m:
            m.setattr(TF, "seq_parallel", lambda shape, mesh: False)
            off = TD.trace_cost(cfg, shape, mesh, peak_only=True)["peak"]
        return off - on, cfg
    (f2, cfg), (f4, _) = fall(2), fall(4)
    S = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    gathered = shape.global_batch // 2 * S * cfg.d_model * 2    # bf16
    share = gathered * (tp - 1) / tp
    print(arch, f2, f4, share, gathered)
    assert abs((f4 - f2) - 2 * share) <= gathered
    assert f2 >= 2 * share and f4 >= 4 * share


NO_JAX = """
import sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import smoke_config
from repro_torch.core import distributed, mesh as core_mesh
from repro_torch.launch import dryrun, dryrun_dhnsw, mesh
from repro_torch.train import checkpoint
mesh.fake_world(8)
m = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
dryrun.trace_cost(smoke_config("qwen3-moe-30b-a3b"),
                  InputShape("t", 64, 8, "train"), m)
dryrun_dhnsw.count(m, "span_dma")
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_mesh_modules_load_no_jax_and_no_reference():
    """The mesh machinery and both dry runs import neither JAX nor the
    JAX package."""
    out = subprocess.run([sys.executable, "-c", NO_JAX], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout

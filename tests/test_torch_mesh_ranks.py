"""The port's meshed steps on four gloo ranks (one spawn for every case)
against the JAX package on four forced CPU devices (one subprocess):

* ``make_train_step`` on a (2, 2) ``("data", "model")`` mesh, the smoke
  qwen3-8b at vocab 512, a batch of 8 x 1024, on the reference's own
  initial params: the loss equals the reference's on the same mesh
  (built with Auto axes: jax 0.9's ``make_mesh`` gives Explicit ones,
  which its ``with_sharding_constraint`` refuses) within 1e-5 in f32, in
  one and two micro-steps; with the perf flags (``REPRO_CAST_PARAMS_ONCE``,
  ``REPRO_LOSS_UNEMBED_TP``, ``REPRO_SHARDED_CE``) on and off in bf16 the
  losses agree within 1e-4;
* ``moe._moe_shardmap`` (the smoke qwen3-moe layer, f32) against the
  reference's ``shard_map`` path;
* ``reshard_tree`` / ``rescale_train_state`` from (2, 2) to (4, 1): every
  value bitwise intact, the new placements the specs' on the new mesh;
* ``ShardedStore.fetch_fn``: bit-equal to the store's rows.

The ranks meet through a file (``init_method="file://..."``), so
parallel test workers cannot collide on a port."""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.layout import build_store  # noqa: E402
from repro_torch.core.meta import build_meta  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402

WORLD = 4
SEQ, BATCH, VOCAB = 1024, 8, 512
MOE_X = (4, 64, 64)           # (B, S, d) of the moe layer's input
LOSS_TOL, FLAGS_TOL = 1e-5, 1e-4

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs.base import InputShape
from repro.configs.registry import smoke_config
from repro.models import model as M
from repro.models import moe as MOE
from repro.models.params import init_params
from repro.train import adamw
from repro.train.train_step import make_train_step
tmp = sys.argv[1]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
base = smoke_config("qwen3-8b").replace(vocab_size=%(vocab)d)
params = init_params(M.param_defs(base), jax.random.key(0))
rng = np.random.default_rng(0)
batch = {k: rng.integers(0, %(vocab)d, (%(batch)d, %(seq)d)).astype(np.int32)
         for k in ("tokens", "labels")}
batch["labels"][0, :5] = -1
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(f"{tmp}/params.npz", **flat, **{"batch_" + k: v
                                         for k, v in batch.items()})
FLAGS = ("REPRO_LOSS_UNEMBED_TP", "REPRO_CAST_PARAMS_ONCE",
         "REPRO_SHARDED_CE")
for name, dtype, micro, flags in (("f32_m1", "float32", 1, False),
                                  ("f32_m2", "float32", 2, False),
                                  ("bf16_off", "bfloat16", 1, False),
                                  ("bf16_on", "bfloat16", 1, True)):
    for f in FLAGS:
        os.environ.pop(f, None)
        if flags:
            os.environ[f] = "1"
    cfg = base.replace(dtype=dtype)
    shape = InputShape("t", %(seq)d, %(batch)d, "train")
    step, in_sh, out_sh, _ = make_train_step(cfg, shape, mesh,
                                             micro_steps=micro)
    with mesh:
        _, _, m = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(
            params, adamw.init(params), {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
for f in FLAGS:
    os.environ.pop(f, None)
mcfg = smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
mp = init_params(MOE.moe_param_defs(mcfg, (), ()), jax.random.key(1))
x = np.random.default_rng(1).standard_normal(%(moe_x)r).astype(np.float32)
with mesh:
    y, aux = jax.jit(lambda p, x: MOE.moe_ffn(mcfg, p, x, mesh))(mp, x)
np.savez(f"{tmp}/moe.npz", x=x, y=np.asarray(y),
         **{k: np.asarray(v) for k, v in mp.items()})
print("JSON " + json.dumps(out))
""" % {"vocab": VOCAB, "batch": BATCH, "seq": SEQ, "moe_x": MOE_X}

RANK = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                        world_size=%(world)d, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import tree as T
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import smoke_config
from repro_torch.core.distributed import ShardedStore
from repro_torch.core.layout import LayoutSpec, Store
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.params import (P, NamedSharding, gather_local,
                                       local_part, param_shardings,
                                       placements, shard_tensor)
from repro_torch.train import adamw, checkpoint as CK
from repro_torch.train import train_step as TS
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
a = np.load(f"{tmp}/params.npz")
base = smoke_config("qwen3-8b").replace(vocab_size=%(vocab)d)


def tree_of(prefix=""):
    out = {}
    for k in a.files:
        if k.startswith("batch_"):
            continue
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(a[k].copy())
    return out


def state(cfg, mesh):
    _, (p_sh, o_sh, b_sh), _, _ = TS.make_step(
        cfg, InputShape("t", %(seq)d, %(batch)d, "train"), mesh)
    p = T.tree_map(shard_tensor, tree_of(), p_sh)
    zeros = T.tree_map(lambda t: torch.zeros(t.shape), tree_of())
    opt = adamw.AdamWState(shard_tensor(torch.zeros((), dtype=torch.int32),
                                        o_sh.step),
                           T.tree_map(shard_tensor, zeros, o_sh.m),
                           T.tree_map(shard_tensor, zeros, o_sh.v))
    b = {k: shard_tensor(torch.from_numpy(a["batch_" + k]), b_sh[k])
         for k in ("tokens", "labels")}
    return p, opt, b


out = {}
FLAGS = ("REPRO_LOSS_UNEMBED_TP", "REPRO_CAST_PARAMS_ONCE",
         "REPRO_SHARDED_CE")
for name, dtype, micro, flags in (("f32_m1", "float32", 1, False),
                                  ("f32_m2", "float32", 2, False),
                                  ("bf16_off", "bfloat16", 1, False),
                                  ("bf16_on", "bfloat16", 1, True)):
    for f in FLAGS:
        os.environ.pop(f, None)
        if flags:
            os.environ[f] = "1"
    cfg = base.replace(dtype=dtype)
    step, _, _, _ = TS.make_step(
        cfg, InputShape("t", %(seq)d, %(batch)d, "train"), mesh,
        micro_steps=micro)
    p, opt, b = state(cfg, mesh)
    p, opt, m = step(p, opt, b)
    out[name] = {k: float(v) for k, v in m.items()}
    out[name]["step"] = int(opt.step.to_local())
for f in FLAGS:
    os.environ.pop(f, None)

# moe: this rank's batch shard through the expert-parallel path
mz = np.load(f"{tmp}/moe.npz")
mcfg = smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
defs = MOE.moe_param_defs(mcfg, (), ())
sh = param_shardings(defs, mesh)
keep = MOE.expert_keep(mcfg, mesh)
mp = {k: gather_local(shard_tensor(torch.from_numpy(mz[k]), sh[k]),
                      keep if k.startswith("we_") else ())
      for k in defs}
xs = NamedSharding(mesh, P("data", None, None))
x = local_part(torch.from_numpy(mz["x"]), xs)
y, aux = MOE._moe_shardmap(mcfg, mp, x, mesh)
np.save(f"{tmp}/moe_y{rank}.npy", y.numpy())
out["moe_path"] = bool(MOE.use_shardmap(mcfg, mesh))
out["moe_expert_shape"] = list(mp["we_g"].shape)

# reshard (2, 2) -> (4, 1): values bitwise, placements the new specs'
p, opt, _ = state(base, mesh)
mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
defs = M.param_defs(base)
p2, opt2 = CK.rescale_train_state(p, opt, defs, mesh41)
new = param_shardings(defs, mesh41)
ok = True
for t, full, s in zip(T.leaves(p2), T.leaves(tree_of()), T.leaves(new)):
    ok &= isinstance(t, DTensor) and t.device_mesh is mesh41
    ok &= list(t.placements) == list(placements(s.spec, mesh41))
    ok &= torch.equal(t.to_local(), local_part(full, s))
for t, s in zip(T.leaves(opt2.m), T.leaves(new)):
    ok &= torch.equal(t.to_local(), torch.zeros(s.local_shape(t.shape)))
back = CK.reshard_tree(p2, param_shardings(defs, mesh))
for t, u in zip(T.leaves(back), T.leaves(p)):
    ok &= torch.equal(t.to_local(), u.to_local())
out["reshard_ok"] = bool(ok)

# a dim over ("pod", "data"): DTensor assembles the shards local_part cut
m3 = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
d = shard_tensor(full, NamedSharding(m3, P(("pod", "data"), None)))
out["multi_pod_ok"] = bool(torch.equal(d.full_tensor(), full)
                           and d.to_local().shape == (2, 6))

# _attend_tp's padded heads (H=6 on tp=4: G 3 -> 4) against plain attend
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
acfg = smoke_config("qwen3-8b").replace(n_heads=6, n_kv_heads=2,
                                        dtype="float32")
gen = torch.Generator().manual_seed(0)
qkv = [torch.randn(2, 16, h, 16, generator=gen) for h in (6, 2, 2)]
got = [t.clone().requires_grad_() for t in qkv]
want = [t.clone().requires_grad_() for t in qkv]
o1 = TF._attend_tp(acfg, *got, 0, m14)
o1.square().sum().backward()
o2 = L.attend(*want, causal=True, window=0)
o2.square().sum().backward()
out["attend_tp_err"] = max(float((a - b).abs().max() / b.abs().max())
                           for a, b in zip([o1] + [t.grad for t in got],
                                           [o2] + [t.grad for t in want]))

# fetch_fn on the world group
s = np.load(f"{tmp}/store.npz")
store = Store(spec=LayoutSpec(**{k[5:]: int(s[k]) for k in s.files
                                 if k.startswith("spec_")}),
              graph_buf=s["graph_buf"], vec_buf=s["vec_buf"],
              meta_table=s["meta_table"], n_base=s["n_base"])
ss = ShardedStore(store, device="cpu")
ids = torch.from_numpy(s["ids"]).long()
g, v = ss.fetch_fn()(ss.graph_buf, ss.vec_buf, ids)
out["fetch_ok"] = bool(np.array_equal(g.numpy(), store.graph_buf[s["ids"]])
                       and np.array_equal(v.numpy().view(np.int32),
                                          store.vec_buf[s["ids"]].view(
                                              np.int32)))
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
""" % {"world": WORLD, "vocab": VOCAB, "batch": BATCH, "seq": SEQ}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.fixture(scope="module")
def runs():
    """(the reference's numbers, each rank's, the tmp dir's arrays)."""
    from repro_torch import convert
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as tmp:
        ref = subprocess.run([sys.executable, "-c", REFERENCE, tmp],
                             capture_output=True, text=True, env=_env(),
                             timeout=900)
        assert ref.returncode == 0, ref.stderr[-3000:]
        want = json.loads(next(line for line in ref.stdout.splitlines()
                               if line.startswith("JSON "))[5:])
        ds = sift_like(n=1500, n_queries=4, seed=1)
        meta = build_meta(ds.data, 12, seed=0)
        store = build_store(ds.data, meta)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, store.graph_buf.shape[0], 40)
        np.savez(f"{tmp}/store.npz", graph_buf=store.graph_buf,
                 vec_buf=store.vec_buf, meta_table=store.meta_table,
                 n_base=store.n_base, ids=ids,
                 **{f"spec_{f}": int(getattr(store.spec, f))
                    for f in convert.SPEC_FIELDS})
        procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), tmp],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=_env()) for r in range(WORLD)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=900)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        got = []
        for r, (p, err) in enumerate(zip(procs, errs)):
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
            with open(f"{tmp}/rank{r}.json") as f:
                got.append(json.load(f))
        moe = dict(np.load(f"{tmp}/moe.npz"))
        ys = [np.load(f"{tmp}/moe_y{r}.npy") for r in range(WORLD)]
    return want, got, moe, ys


@pytest.mark.parametrize("name", ["f32_m1", "f32_m2"])
def test_meshed_train_step_matches_reference(runs, name):
    """f32 loss within 1e-5 of the reference's meshed step on the same
    (2, 2) mesh and params; every rank reports the same loss and one
    step."""
    want, got, _, _ = runs
    print(name, want[name], [r[name] for r in got])
    for r in got:
        assert abs(r[name]["loss"] - want[name]["loss"]) <= LOSS_TOL, (
            r[name], want[name])
        assert r[name]["loss"] == got[0][name]["loss"]
        assert abs(r[name]["grad_norm"] - want[name]["grad_norm"]) <= (
            1e-4 * max(1.0, want[name]["grad_norm"]))
        assert r[name]["step"] == 1


def test_perf_flags_agree(runs):
    """bf16, flags on against off within 1e-4 (the reference's test's
    bound), and each within bf16 reach of the reference's."""
    want, got, _, _ = runs
    print("flags", want["bf16_off"], want["bf16_on"], got[0]["bf16_off"],
          got[0]["bf16_on"])
    for r in got:
        assert abs(r["bf16_on"]["loss"] - r["bf16_off"]["loss"]) < FLAGS_TOL
    assert abs(want["bf16_on"]["loss"] - want["bf16_off"]["loss"]) < FLAGS_TOL


def test_moe_shardmap_matches_reference(runs):
    """The expert-parallel path (E/ep experts a rank, its ff shards
    gathered over data) on every rank against the reference's
    ``shard_map`` path; a rank's y is its data shard's."""
    _, got, moe, ys = runs
    print("moe: max |y| %.6g, max |diff| %s" % (
        float(np.abs(moe["y"]).max()),
        [float(np.abs(y - moe["y"][(r // 2) * MOE_X[0] // 2:
                                  (r // 2 + 1) * MOE_X[0] // 2]).max())
         for r, y in enumerate(ys)]))
    assert all(r["moe_path"] for r in got)
    # E/ep experts, d, ff/fsdp: _moe_shardmap gathers the ff shards
    assert got[0]["moe_expert_shape"] == [2, 64, 32]
    B = MOE_X[0]
    for r, y in enumerate(ys):
        d = r // 2
        want = moe["y"][d * B // 2:(d + 1) * B // 2]
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5 * float(
            np.abs(moe["y"]).max()))


def test_reshard_and_fetch_fn(runs):
    """Resharding (2, 2) -> (4, 1) and back keeps every value; a dim
    sharded over ("pod", "data") round-trips through DTensor; the fetch
    is bit-equal to the store's rows."""
    _, got, _, _ = runs
    assert all(r["reshard_ok"] for r in got)
    assert all(r["multi_pod_ok"] for r in got)
    assert all(r["fetch_ok"] for r in got)


def test_attend_tp_padded_heads(runs):
    """6 heads over 2 kv heads on a model axis of 4 (H % tp != 0, H >
    tp): the GQA group padded to 4, a rank's 2 padded heads, gathered
    and cut back; output and q, k, v gradients equal plain ``attend``'s
    within 1e-5 of each tensor's largest magnitude (f32 rounding, as
    ``tests/lm_parity.py`` holds f32 leaves)."""
    _, got, _, _ = runs
    assert all(r["attend_tp_err"] <= 1e-5 for r in got), [
        r["attend_tp_err"] for r in got]

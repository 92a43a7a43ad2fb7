"""The port's meshed steps with values on four gloo ranks (one spawn for
every case) against the JAX package's on four forced CPU devices (one
subprocess, run at the same time), both on a (2, 2) ``("data",
"model")`` mesh (the reference's built with Auto axes: jax 0.9's
``make_mesh`` gives Explicit ones, which its ``with_sharding_constraint``
refuses):

* ``make_prefill_step`` then ``make_decode_step`` (``STEPS`` steps fed
  fixed tokens) in f32 on bf16 serving weights, for the smoke qwen3-8b
  (its kv heads over ``model``) and for it with one kv head (the cache
  over its sequence instead): the prefill's and every decode step's
  logits within ``LOGIT_TOL`` of the largest, and each one's argmax
  equal;
* the train step of the smoke qwen3-moe in f32 (``_moe_shardmap``'s
  backward: the ff gradients reduce-scattered over ``data``, the E/ep
  experts' gradients, the gates' ``to_model``): loss within 1e-5, and
  aux and grad_norm within 1e-4 of the reference's;
* ``dryrun_dhnsw.make_step``, the six variants at the reference's
  geometry with the store cut to 8 partitions (4 groups of blocks):
  each distance within 1e-5 of the reference's and the top-k ids equal
  up to ties; the doorbell batch holds a span that straddles the shard
  boundary, so ``span_dma``'s clamp is read too.

The inputs are drawn here (numpy, the port's ``init_params``) and handed
to both sides through a temporary directory; the ranks meet through a
file there (``init_method="file://..."``), so parallel test workers
cannot collide on a port."""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import ParamDef, init_params  # noqa: E402

WORLD = 4
VOCAB = 512
SERVE_B, SERVE_S, STEPS = 4, 32, 3
TRAIN_B, TRAIN_S = 8, 256
LOGIT_TOL = 1e-5
VARIANTS = ("baseline", "sharded", "quantized", "int8_rest", "span_dma",
            "bf16_serve")
# the serve configs: name -> n_kv_heads (2: over model; 1: the cache
# over its sequence, K % tp != 0)
SERVE = {"kv2": 2, "kv1": 1}

# the cut store: 4 groups of blocks (8 partitions), on a model axis of 2
DHNSW_CUT = """
DH.N_PARTS = 8
DH.N_BLOCKS = 4 * (2 * DH.DATA_BLOCKS + DH.OV_BLOCKS)
"""

COMMON = r"""
import json, os, sys
import numpy as np
tmp = sys.argv[-1]
a = np.load(f"{tmp}/inputs.npz")
VARIANTS = %(variants)r
SERVE = %(serve)r


def tree_of(defs, prefix, cast, is_leaf):
    if is_leaf(defs):
        return cast(a[prefix], defs.dtype)
    return {k: tree_of(v, f"{prefix}/{k}" if prefix else k, cast, is_leaf)
            for k, v in defs.items()}


def dhnsw_args(v):
    vec = a["dh_vec8"] if v in ("int8_rest", "span_dma", "bf16_serve") \
        else a["dh_vec"]
    rest = [a["dh_" + k] for k in ("ids", "q", "slot", "valid")]
    if v == "baseline":
        rest = [x[0] for x in rest]
    return [vec] + rest
""" % {"variants": VARIANTS, "serve": SERVE}

REFERENCE = r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import InputShape
from repro.configs.registry import smoke_config
from repro.models import model as M
from repro.models.params import ParamDef
from repro.train import adamw
from repro.train.train_step import (make_decode_step, make_prefill_step,
                                    make_train_step)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
import repro.launch.dryrun_dhnsw as DH   # after the backend has 4 devices
out, arrays = {}, {}
leaf = lambda x: isinstance(x, ParamDef)
cast = lambda x, dt: jnp.asarray(x, dtype=dt)

for name, kv in SERVE.items():
    cfg = smoke_config("qwen3-8b").replace(vocab_size=%(vocab)d,
                                           n_kv_heads=kv, dtype="float32")
    params = tree_of(M.serve_param_defs(cfg), f"serve_{name}", cast, leaf)
    toks = a[f"serve_{name}_tokens"]
    total = %(S)d + %(steps)d
    pre, (p_sh, b_sh), o_sh, _ = make_prefill_step(
        cfg, InputShape("p", %(S)d, %(B)d, "prefill"), mesh)
    dec, d_in, d_out, _ = make_decode_step(
        cfg, InputShape("d", total, %(B)d, "decode"), mesh)
    with mesh:
        logits, cache = jax.jit(pre, in_shardings=(p_sh, b_sh),
                                out_shardings=o_sh)(params,
                                                    {"tokens": toks})
        got = [np.asarray(logits)]
        pad = [(0, 0), (0, 0), (0, %(steps)d), (0, 0), (0, 0)]
        cache = tuple(jax.device_put(jnp.pad(c, pad), sh)
                      for c, sh in zip(cache, d_in[1]))
        step = jax.jit(dec, in_shardings=d_in, out_shardings=d_out)
        for i in range(%(steps)d):
            pos = np.full((%(B)d,), %(S)d + i, np.int32)
            logits, cache = step(params, cache,
                                 a[f"serve_{name}_next"][:, i], pos)
            got.append(np.asarray(logits))
    for i, g in enumerate(got):
        arrays[f"serve_{name}_{i}"] = g

mcfg = smoke_config("qwen3-moe-30b-a3b").replace(vocab_size=%(vocab)d,
                                                 dtype="float32")
params = tree_of(M.param_defs(mcfg), "moe", cast, leaf)
step, in_sh, out_sh, _ = make_train_step(
    mcfg, InputShape("t", %(TS)d, %(TB)d, "train"), mesh)
with mesh:
    _, _, m = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(
        params, adamw.init(params), {k: a["moe_" + k]
                                     for k in ("tokens", "labels")})
out["moe"] = {k: float(v) for k, v in m.items()}
# each data shard's aux, unmeshed (its half of the batch)
half = %(TB)d // 2
out["moe_half_aux"] = [float(jax.jit(lambda p, t: M.forward(
    mcfg, p, {"tokens": t}, return_hidden=True)[1])(
        params, a["moe_tokens"][h * half:(h + 1) * half])) for h in (0, 1)]
%(cut)s
for v in VARIANTS:
    step, specs, in_sh, out_sh = DH.make_step(mesh, v)
    args = dhnsw_args(v)
    assert args[0].shape == specs["vec"].shape, (args[0].shape, specs["vec"])
    with mesh:
        d, i = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(*args)
    arrays[f"dh_{v}_d"], arrays[f"dh_{v}_i"] = np.asarray(d), np.asarray(i)
np.savez(f"{tmp}/reference.npz", **arrays)
print("JSON " + json.dumps(out))
""" % {"vocab": VOCAB, "S": SERVE_S, "B": SERVE_B, "steps": STEPS,
       "TS": TRAIN_S, "TB": TRAIN_B, "cut": DHNSW_CUT}

RANK = r"""
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                        world_size=%(world)d, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import tree as T
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun_dhnsw as DH
from repro_torch.models import model as M
from repro_torch.models.params import ParamDef, shard_tensor
from repro_torch.train import adamw
from repro_torch.train import train_step as TS
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out, arrays = {}, {}
leaf = lambda x: isinstance(x, ParamDef)
cast = lambda x, dt: torch.from_numpy(np.array(x)).to(dt)


def placed(tree, shardings):
    return T.tree_map(shard_tensor, tree, shardings)


with torch.no_grad():
    for name, kv in SERVE.items():
        cfg = smoke_config("qwen3-8b").replace(vocab_size=%(vocab)d,
                                               n_kv_heads=kv,
                                               dtype="float32")
        total = %(S)d + %(steps)d
        pre, (p_sh, b_sh), _, _ = TS.make_prefill_step(
            cfg, InputShape("p", %(S)d, %(B)d, "prefill"), mesh)
        dec, (_, c_sh, t_sh, q_sh), _, _ = TS.make_decode_step(
            cfg, InputShape("d", total, %(B)d, "decode"), mesh)
        params = placed(tree_of(M.serve_param_defs(cfg), f"serve_{name}",
                                cast, leaf), p_sh)
        toks = torch.from_numpy(a[f"serve_{name}_tokens"])
        logits, cache = pre(params, {"tokens": shard_tensor(
            toks, b_sh["tokens"])})
        got = [logits.full_tensor()]
        cache = [shard_tensor(torch.nn.functional.pad(
            c.full_tensor(), (0, 0, 0, 0, 0, %(steps)d)), s)
            for c, s in zip(cache, c_sh)]
        for i in range(%(steps)d):
            nxt = torch.from_numpy(a[f"serve_{name}_next"][:, i].copy())
            pos = torch.full((%(B)d,), %(S)d + i, dtype=torch.int32)
            logits, cache = dec(params, tuple(cache),
                                shard_tensor(nxt, t_sh),
                                shard_tensor(pos, q_sh))
            got.append(logits.full_tensor())
        for i, g in enumerate(got):
            arrays[f"serve_{name}_{i}"] = g.numpy()

mcfg = smoke_config("qwen3-moe-30b-a3b").replace(vocab_size=%(vocab)d,
                                                 dtype="float32")
step, (p_sh, o_sh, b_sh), _, _ = TS.make_step(
    mcfg, InputShape("t", %(TS)d, %(TB)d, "train"), mesh)
full = tree_of(M.param_defs(mcfg), "moe", cast, leaf)
zeros = T.tree_map(lambda t: torch.zeros(t.shape), full)
opt = adamw.AdamWState(shard_tensor(torch.zeros((), dtype=torch.int32),
                                    o_sh.step),
                       placed(zeros, o_sh.m), placed(zeros, o_sh.v))
_, opt, m = step(placed(full, p_sh), opt,
                 {k: shard_tensor(torch.from_numpy(a["moe_" + k]), b_sh[k])
                  for k in ("tokens", "labels")})
out["moe"] = {k: float(v) for k, v in m.items()}
out["moe"]["step"] = int(opt.step.to_local())
%(cut)s
with torch.no_grad():
    for v in VARIANTS:
        step, specs, in_sh, _ = DH.make_step(mesh, v)
        args = [shard_tensor(torch.from_numpy(np.array(x)), s)
                for x, s in zip(dhnsw_args(v), in_sh)]
        assert tuple(args[0].shape) == tuple(specs["vec"].shape)
        d, i = step(*args)
        arrays[f"dh_{v}_d"] = d.full_tensor().numpy()
        arrays[f"dh_{v}_i"] = i.full_tensor().numpy()
np.savez(f"{tmp}/rank{rank}.npz", **arrays)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
""" % {"world": WORLD, "vocab": VOCAB, "S": SERVE_S, "B": SERVE_B,
       "steps": STEPS, "TS": TRAIN_S, "TB": TRAIN_B, "cut": DHNSW_CUT}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _flat(tree, prefix) -> dict:
    """A params tree as f32 numpy arrays keyed by their paths (bf16 values
    are exact in f32; each side casts back to its def's dtype)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, f"{prefix}/{k}").items()}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for i, (name, kv) in enumerate(SERVE.items()):
        cfg = smoke_config("qwen3-8b").replace(vocab_size=VOCAB,
                                               n_kv_heads=kv, dtype="float32")
        out.update(_flat(init_params(M.serve_param_defs(cfg),
                                     torch.Generator().manual_seed(i)),
                         f"serve_{name}"))
        out[f"serve_{name}_tokens"] = rng.integers(
            0, VOCAB, (SERVE_B, SERVE_S)).astype(np.int32)
        out[f"serve_{name}_next"] = rng.integers(
            0, VOCAB, (SERVE_B, STEPS)).astype(np.int32)
    mcfg = smoke_config("qwen3-moe-30b-a3b").replace(vocab_size=VOCAB,
                                                     dtype="float32")
    out.update(_flat(init_params(M.param_defs(mcfg),
                                 torch.Generator().manual_seed(7)), "moe"))
    for k in ("tokens", "labels"):
        out["moe_" + k] = rng.integers(0, VOCAB, (TRAIN_B, TRAIN_S)).astype(
            np.int32)
    out["moe_labels"][0, :5] = -1
    # the d-HNSW store cut to 4 groups on a model axis of 2: 352 blocks,
    # 176 a shard (a multiple of a group, so span_dma pads nothing)
    from repro_torch.launch import dryrun_dhnsw as DH
    group = DH.GROUP_BLOCKS
    n_blocks, per_shard, dp = 4 * group, 2 * group, 2
    vec = rng.uniform(-1, 1, (n_blocks, DH.VBLK)).astype(np.float32)
    out["dh_vec"] = vec
    out["dh_vec8"] = np.clip(np.round(vec * 127), -127, 127).astype(np.int8)
    parts = rng.integers(0, 8, (dp, DH.M_FETCH))
    starts = (parts // 2) * group + (parts % 2) * DH.DATA_BLOCKS
    # a span that straddles the shard boundary: span_dma clamps it into
    # its owner's shard, the row gathers read both owners
    starts[:, 3] = per_shard - 20
    out["dh_ids"] = (starts[..., None] + np.arange(DH.FETCH_BLOCKS)
                     ).reshape(dp, -1).astype(np.int32)
    out["dh_q"] = rng.uniform(-1, 1, (dp, DH.PAIRS, DH.DIM)).astype(
        np.float32)
    out["dh_slot"] = rng.integers(0, DH.M_FETCH, (dp, DH.PAIRS)).astype(
        np.int32)
    out["dh_valid"] = rng.uniform(size=(dp, DH.PAIRS)) < 0.9
    return out


@pytest.fixture(scope="module")
def runs():
    """(the reference's numbers, its arrays, each rank's numbers and
    arrays)."""
    with tempfile.TemporaryDirectory(prefix="mesh_steps_") as tmp:
        np.savez(f"{tmp}/inputs.npz", **_inputs())
        ref = subprocess.Popen([sys.executable, "-c", COMMON + REFERENCE,
                                tmp], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=_env())
        procs = [subprocess.Popen([sys.executable, "-c", COMMON + RANK,
                                   str(r), tmp], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=_env()) for r in range(WORLD)]
        outs = []
        try:
            for p in [ref] + procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in [ref] + procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert ref.returncode == 0, outs[0][1][-3000:]
        want = json.loads(next(line for line in outs[0][0].splitlines()
                               if line.startswith("JSON "))[5:])
        want_a = dict(np.load(f"{tmp}/reference.npz"))
        got = []
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}: {outs[r + 1][1][-3000:]}"
            with open(f"{tmp}/rank{r}.json") as f:
                got.append((json.load(f), dict(np.load(f"{tmp}/rank{r}.npz"))))
    return want, want_a, got


@pytest.mark.parametrize("name", list(SERVE))
def test_meshed_prefill_and_decode_match_reference(runs, name):
    """The prefill's logits and each decode step's, on every rank, within
    ``LOGIT_TOL`` of the largest logit (f32 compute on the same bf16
    weights: the two frameworks sum in other orders), and every argmax
    (the greedy token) equal."""
    _, want_a, got = runs
    for i in range(STEPS + 1):
        want = want_a[f"serve_{name}_{i}"]
        scale = float(np.abs(want).max())
        for r, (_, arr) in enumerate(got):
            g = arr[f"serve_{name}_{i}"]
            print(name, i, r, float(np.abs(g - want).max()) / scale)
            assert g.shape == want.shape
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=LOGIT_TOL * scale)
            assert np.array_equal(g.argmax(-1), want.argmax(-1))


def test_meshed_moe_train_step_matches_reference(runs):
    """The smoke qwen3-moe's train step on the (2, 2) mesh: every rank's
    loss within 1e-5 of the reference's and the same on every rank, and
    grad_norm (which reads every gradient, the experts' and the gathered
    ff shards' among them) within 1e-4 relative.

    The aux metric: the reference's ``shard_map`` returns its local aux
    under ``P()`` unchecked, so the metric it reports is data shard 0's
    (checked here against the aux of an unmeshed forward on that half of
    the batch); the port reports the mean over the data shards, whose
    gradient is the one the reference's transpose gives (grad_norm
    agrees).  Both within 1e-4 relative of those unmeshed readings."""
    want, _, got = runs
    w, halves = want["moe"], want["moe_half_aux"]
    print("moe", w, halves, [m["moe"] for m, _ in got])
    assert abs(w["aux"] - halves[0]) <= 1e-4 * abs(halves[0])
    for m, _ in got:
        m = m["moe"]
        assert abs(m["loss"] - w["loss"]) <= 1e-5
        assert m["loss"] == got[0][0]["moe"]["loss"]
        assert abs(m["grad_norm"] - w["grad_norm"]) <= 1e-4 * max(
            1.0, w["grad_norm"])
        mean = sum(halves) / 2
        assert abs(m["aux"] - mean) <= 1e-4 * abs(mean), (m, halves)
        assert m["step"] == 1


def _tie_equal(ids, d, ref_ids, ref_d) -> bool:
    """Top-k ids equal to the reference's, or differing only where two
    distances of the reference's row tie within 1e-5 relative."""
    for row in np.argwhere((ids != ref_ids).any(-1)).reshape(-1, ids.ndim - 1):
        rd, ri, gi = ref_d[tuple(row)], ref_ids[tuple(row)], ids[tuple(row)]
        if set(ri[np.isfinite(rd)]) == set(gi[np.isfinite(rd)]):
            continue                    # the same set, ties in another order
        for j in np.nonzero(ri != gi)[0]:
            near = np.abs(rd - rd[j]) <= 1e-5 * max(abs(rd[j]), 1e-6)
            if near.sum() < 2 and np.isfinite(rd[j]):
                return False
    return True


@pytest.mark.parametrize("variant", VARIANTS)
def test_dhnsw_step_matches_reference(runs, variant):
    """``dryrun_dhnsw.make_step`` run for real on the (2, 2) mesh: every
    rank's distances within 1e-5 relative of the reference's (inf where a
    pair is invalid) and its top-k ids equal up to ties."""
    _, want_a, got = runs
    wd, wi = want_a[f"dh_{variant}_d"], want_a[f"dh_{variant}_i"]
    for r, (_, arr) in enumerate(got):
        d, i = arr[f"dh_{variant}_d"], arr[f"dh_{variant}_i"]
        assert d.shape == wd.shape and i.shape == wi.shape
        assert np.array_equal(np.isinf(d), np.isinf(wd))
        fin = np.isfinite(wd)
        np.testing.assert_allclose(d[fin], wd[fin], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(wd[fin]).max()))
        assert _tie_equal(i, d, wi, wd), (variant, r)

"""The meshed steps of the families beside the transformer's (the smoke
mamba2-370m, zamba2-2.7b and whisper-tiny) on four gloo ranks (one
spawn for every case) against the JAX package's meshed steps on four
forced CPU devices (one subprocess, run at the same time; its meshes
built with Auto axes, as ``tests/test_torch_mesh_steps.py`` says why),
on a (2, 2) and a (1, 4) ``("data", "model")`` mesh:

* ``make_prefill_step`` then ``STEPS`` steps of ``make_decode_step`` fed
  fixed tokens, in f32 on bf16 serving weights: the prefill's and every
  decode step's logits within ``LOGIT_TOL`` of the largest, and each
  one's argmax equal.  The decode's cache is ``SERVE_S + PAD`` long, a
  multiple of 4, so on (1, 4) the kv caches (2 kv heads on 4 ranks) lie
  over their sequence and the ranks' softmax parts are merged by their
  log-sum-exp, the last rank's holding no valid key (positions 36 on);
  on (2, 2) they lie over their heads;
* ``make_train_step`` in f32: loss within 1e-5, grad_norm within 1e-4
  relative.

The inputs are drawn here (numpy, the port's ``init_params``) and handed
to both sides through a temporary directory; the ranks meet through a
file there.  They run on one torch thread (``OMP_NUM_THREADS=1``)."""
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
from repro_torch.models.params import init_params  # noqa: E402

WORLD = 4
ARCHS = ("mamba2-370m", "zamba2-2.7b", "whisper-tiny")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SERVE_B, SERVE_S, STEPS, PAD = 4, 32, 3, 16
TRAIN_B, TRAIN_S = 8, 64
LOGIT_TOL, LOSS_TOL, NORM_TOL = 1e-5, 1e-5, 1e-4
# the cache tensors that grow with the sequence (padded for the decode)
SEQ_CACHES = {"mamba2-370m": (), "zamba2-2.7b": (3, 4),
              "whisper-tiny": (0, 1)}

COMMON = r"""
import json, os, sys
import numpy as np
tmp = sys.argv[-1]
a = np.load(f"{tmp}/inputs.npz")
ARCHS, MESHES, SEQ_CACHES = %(archs)r, %(meshes)r, %(seq)r
B, S, STEPS, PAD, TB, TS = %(B)d, %(S)d, %(steps)d, %(pad)d, %(TB)d, %(TS)d


def tree_of(defs, prefix, cast, is_leaf):
    if is_leaf(defs):
        return cast(a[prefix], defs.dtype)
    return {k: tree_of(v, f"{prefix}/{k}", cast, is_leaf)
            for k, v in defs.items()}


def config(smoke_config, arch):
    return smoke_config(arch).replace(dtype="float32")


def batch(arch, kind):
    out = {"tokens": a[f"{arch}_{kind}_tokens"]}
    if kind == "train":
        out["labels"] = a[f"{arch}_train_labels"]
    if arch == "whisper-tiny":
        out["frames"] = a[f"{arch}_{kind}_frames"]
    return out
""" % {"archs": ARCHS, "meshes": MESHES, "seq": SEQ_CACHES, "B": SERVE_B,
       "S": SERVE_S, "steps": STEPS, "pad": PAD, "TB": TRAIN_B,
       "TS": TRAIN_S}

REFERENCE = r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
from repro.configs.base import InputShape
from repro.configs.registry import smoke_config
from repro.models import model as M
from repro.models.params import ParamDef
from repro.train import adamw
from repro.train.train_step import (make_decode_step, make_prefill_step,
                                    make_train_step)
from concurrent.futures import ThreadPoolExecutor
out, arrays = {}, {}
leaf = lambda x: isinstance(x, ParamDef)
# host arrays only, placed by device_put: an eager jnp op would compile
cast = lambda x, dt: np.asarray(x).astype(dt)


def compiled(mesh, made):
    fn, in_sh, out_sh, abstract = made
    with mesh:
        return jax.jit(fn, in_shardings=in_sh,
                       out_shardings=out_sh).lower(*abstract).compile()


def put(tree, shardings):
    return jax.tree.map(jax.device_put, tree, shardings)


# every step compiled at once (XLA compiles off the GIL), then run in turn
meshes = {m: jax.make_mesh(shape, ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
          for m, shape in MESHES.items()}
made = {}
for mname, mesh in meshes.items():
    for arch in ARCHS:
        cfg = config(smoke_config, arch)
        made[mname, arch] = (
            make_prefill_step(cfg, InputShape("p", S, B, "prefill"), mesh),
            make_decode_step(cfg, InputShape("d", S + PAD, B, "decode"),
                             mesh),
            make_train_step(cfg, InputShape("t", TS, TB, "train"), mesh))
with ThreadPoolExecutor(8) as ex:
    jobs = {k: [ex.submit(compiled, meshes[k[0]], m) for m in v]
            for k, v in made.items()}
for (mname, arch), (pre, dec, tstep) in jobs.items():
    cfg = config(smoke_config, arch)
    (_, (p_sh, b_sh), _, _), (_, d_in, _, _), (_, t_sh, _, _) = made[
        mname, arch]
    params = put(tree_of(M.serve_param_defs(cfg), f"{arch}_serve", cast,
                         leaf), p_sh)
    logits, cache = pre.result()(params, put(batch(arch, "serve"), b_sh))
    got = [np.asarray(logits)]
    cache = tuple(jax.device_put(np.pad(
        np.asarray(c), [(0, 0), (0, 0), (0, PAD), (0, 0), (0, 0)])
        if i in SEQ_CACHES[arch] else c, sh)
        for i, (c, sh) in enumerate(zip(cache, d_in[1])))
    step = dec.result()
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        logits, cache = step(params, cache, *put(
            (a[f"{arch}_serve_next"][:, i], pos), d_in[2:]))
        got.append(np.asarray(logits))
    for i, g in enumerate(got):
        arrays[f"{mname}_{arch}_{i}"] = g
    tparams = tree_of(M.param_defs(cfg), f"{arch}_train", cast, leaf)
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), tparams)
    _, _, m = tstep.result()(*put(
        (tparams, adamw.AdamWState(np.zeros((), np.int32), zeros, zeros),
         batch(arch, "train")), t_sh))
    out[f"{mname}_{arch}"] = {k: float(v) for k, v in m.items()}
np.savez(f"{tmp}/reference.npz", **arrays)
print("JSON " + json.dumps(out))
"""

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
from repro_torch.models import model as M
from repro_torch.models.params import ParamDef, shard_tensor
from repro_torch.train import adamw
from repro_torch.train import train_step as STEP
out, arrays = {}, {}
leaf = lambda x: isinstance(x, ParamDef)
cast = lambda x, dt: torch.from_numpy(np.array(x)).to(dt)


def placed(tree, shardings):
    return T.tree_map(shard_tensor, tree, shardings)


def inputs(arch, kind, shardings):
    return {k: shard_tensor(torch.from_numpy(np.array(v)), shardings[k])
            for k, v in batch(arch, kind).items()}


for mname, shape in MESHES.items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    for arch in ARCHS:
        cfg = config(smoke_config, arch)
        with torch.no_grad():
            pre, (p_sh, b_sh), _, _ = STEP.make_prefill_step(
                cfg, InputShape("p", S, B, "prefill"), mesh)
            dec, (_, c_sh, t_sh, q_sh), _, _ = STEP.make_decode_step(
                cfg, InputShape("d", S + PAD, B, "decode"), mesh)
            params = placed(tree_of(M.serve_param_defs(cfg),
                                    f"{arch}_serve", cast, leaf), p_sh)
            logits, cache = pre(params, inputs(arch, "serve", b_sh))
            got = [logits.full_tensor()]
            cache = tuple(shard_tensor(torch.nn.functional.pad(
                c.full_tensor(), (0, 0, 0, 0, 0, PAD))
                if i in SEQ_CACHES[arch] else c.full_tensor(), s)
                for i, (c, s) in enumerate(zip(cache, c_sh)))
            for i in range(STEPS):
                nxt = torch.from_numpy(a[f"{arch}_serve_next"][:, i].copy())
                pos = torch.full((B,), S + i, dtype=torch.int32)
                logits, cache = dec(params, cache, shard_tensor(nxt, t_sh),
                                    shard_tensor(pos, q_sh))
                got.append(logits.full_tensor())
        for i, g in enumerate(got):
            arrays[f"{mname}_{arch}_{i}"] = g.numpy()
        step, (p_sh, o_sh, b_sh), _, _ = STEP.make_step(
            cfg, InputShape("t", TS, TB, "train"), mesh)
        full = tree_of(M.param_defs(cfg), f"{arch}_train", cast, leaf)
        zeros = T.tree_map(lambda t: torch.zeros(t.shape), full)
        opt = adamw.AdamWState(
            shard_tensor(torch.zeros((), dtype=torch.int32), o_sh.step),
            placed(zeros, o_sh.m), placed(zeros, o_sh.v))
        _, _, m = step(placed(full, p_sh), opt, inputs(arch, "train", b_sh))
        out[f"{mname}_{arch}"] = {k: float(v) for k, v in m.items()}
np.savez(f"{tmp}/rank{rank}.npz", **arrays)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
""" % {"world": WORLD}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
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
    for i, arch in enumerate(ARCHS):
        cfg = smoke_config(arch).replace(dtype="float32")
        V = cfg.vocab_size
        out.update(_flat(init_params(M.serve_param_defs(cfg),
                                     torch.Generator().manual_seed(i)),
                         f"{arch}_serve"))
        out.update(_flat(init_params(M.param_defs(cfg),
                                     torch.Generator().manual_seed(10 + i)),
                         f"{arch}_train"))
        out[f"{arch}_serve_tokens"] = rng.integers(
            0, V, (SERVE_B, SERVE_S)).astype(np.int32)
        out[f"{arch}_serve_next"] = rng.integers(
            0, V, (SERVE_B, STEPS)).astype(np.int32)
        for k in ("tokens", "labels"):
            out[f"{arch}_train_{k}"] = rng.integers(
                0, V, (TRAIN_B, TRAIN_S)).astype(np.int32)
        out[f"{arch}_train_labels"][0, :5] = -1
        if cfg.family == "encdec":
            for kind, b in (("serve", SERVE_B), ("train", TRAIN_B)):
                out[f"{arch}_{kind}_frames"] = rng.standard_normal(
                    (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs():
    """(the reference's numbers, its arrays, each rank's numbers and
    arrays)."""
    with tempfile.TemporaryDirectory(prefix="mesh_families_") as tmp:
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


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_matches_reference(runs, arch, mesh):
    """The prefill's logits and each decode step's, on every rank, within
    ``LOGIT_TOL`` of the largest logit (f32 compute on the same bf16
    weights: the sums run in other orders), and every argmax equal."""
    _, want_a, got = runs
    for i in range(STEPS + 1):
        want = want_a[f"{mesh}_{arch}_{i}"]
        scale = float(np.abs(want).max())
        for r, (_, arr) in enumerate(got):
            g = arr[f"{mesh}_{arch}_{i}"]
            print(arch, mesh, i, r, float(np.abs(g - want).max()) / scale)
            assert g.shape == want.shape
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=LOGIT_TOL * scale)
            assert np.array_equal(g.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_step_matches_reference(runs, arch, mesh):
    """Every rank's loss within ``LOSS_TOL`` of the reference's and the
    same on every rank; grad_norm (every gradient, the model-sharded
    ones summed back from the ranks' shares) within ``NORM_TOL``
    relative."""
    want, _, got = runs
    w = want[f"{mesh}_{arch}"]
    print(arch, mesh, w, [m[f"{mesh}_{arch}"] for m, _ in got])
    for m, _ in got:
        m = m[f"{mesh}_{arch}"]
        assert abs(m["loss"] - w["loss"]) <= LOSS_TOL
        assert m["loss"] == got[0][0][f"{mesh}_{arch}"]["loss"]
        assert abs(m["grad_norm"] - w["grad_norm"]) <= NORM_TOL * max(
            1.0, w["grad_norm"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_heads_must_split_over_model(arch):
    """A meshed mamba2 mixer runs nh/tp heads a rank: a ``model`` axis
    that does not divide the heads is refused, not run replicated."""
    from repro_torch.models import mamba2
    from repro_torch.models.params import AbstractMesh
    cfg = smoke_config(arch)
    nh = mamba2.dims(cfg)[1]
    ok = AbstractMesh((2, 4), ("data", "model"))
    assert nh % 4 == 0 and mamba2.ssm_tp(cfg, ok) == 4
    assert mamba2.ssm_tp(cfg, None) == 1
    with pytest.raises(ValueError, match="do not split"):
        mamba2.ssm_tp(cfg, AbstractMesh((1, 3), ("data", "model")))

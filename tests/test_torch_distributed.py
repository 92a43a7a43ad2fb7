"""The port's ``ShardedStore`` (``repro_torch.core.distributed``) on the
CPU: four gloo ranks, each its own process, against the store's own
arrays and against the JAX package's ``ShardedStore`` over a (2, 4) mesh
of fake host devices (a subprocess, as ``tests/test_distributed.py``
runs it).  The ranks meet through a file (``init_method="file://..."``),
so parallel test workers cannot collide on a port."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core.layout import build_store  # noqa: E402
from repro_torch.core.meta import build_meta  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402

WORLD = 4

RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.core.distributed import ShardedStore
from repro_torch.core.layout import LayoutSpec, Store
rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                        world_size=%(world)d, rank=rank)
a = np.load(f"{tmp}/store.npz")
store = Store(spec=LayoutSpec(**{k[5:]: int(a[k]) for k in a.files
                                 if k.startswith("spec_")}),
              graph_buf=a["graph_buf"], vec_buf=a["vec_buf"],
              meta_table=a["meta_table"], n_base=a["n_base"])
ss = ShardedStore(store, device="cpu")
calls = []
real = dist.all_reduce
dist.all_reduce = lambda *x, **k: calls.append(1) or real(*x, **k)
out = {}
for name in ("ids_a", "ids_b"):
    n = len(calls)
    g, v = ss.fetch(a[name])
    out[name + "_calls"] = len(calls) - n
    out[name + "_g"], out[name + "_v"] = g.numpy(), v.numpy()
out["shard_graph"] = ss.graph_buf.numpy()
out["owners"] = ss.partition_owners(store)
out["owner_of"] = np.array([ss.owner_of(int(b)) for b in a["ids_a"]])
out["n_blocks"], out["per_shard"] = ss.n_blocks, ss.per_shard
out["fetches"] = ss.stats["fetches"]
out["operand_bytes"] = ss.stats["operand_bytes"]
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.destroy_process_group()
""" % {"world": WORLD}

REFERENCE = """
import sys, numpy as np, jax
from repro.core.distributed import ShardedStore
from repro.core.layout import LayoutSpec, Store
tmp = sys.argv[1]
a = np.load(f"{tmp}/store.npz")
store = Store(spec=LayoutSpec(**{k[5:]: int(a[k]) for k in a.files
                                 if k.startswith("spec_")}),
              graph_buf=a["graph_buf"], vec_buf=a["vec_buf"],
              meta_table=a["meta_table"], n_base=a["n_base"])
ss = ShardedStore(store, jax.make_mesh((2, 4), ("data", "model")))
out = {"owners": ss.partition_owners(store), "n_blocks": ss.n_blocks,
       "per_shard": ss.per_shard,
       "owner_of": np.array([ss.owner_of(int(b)) for b in a["ids_a"]])}
for name in ("ids_a", "ids_b"):
    g, v = ss.fetch(a[name])
    out[name + "_g"], out[name + "_v"] = np.asarray(g), np.asarray(v)
np.savez(f"{tmp}/reference.npz", **out)
"""


def _env(**extra):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/root"),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
           "OMP_NUM_THREADS": "1", **extra}
    return env


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The store's arrays, the fetched ids, each rank's results and the
    JAX package's."""
    tmp = tmp_path_factory.mktemp("sharded")
    ds = sift_like(n=1500, n_queries=4, seed=1)
    meta = build_meta(ds.data, 12, seed=0)
    store = build_store(ds.data, meta)
    _, arrays = convert.numpy_state(meta, store)
    vec = arrays["vec_buf"].copy()
    ids_a = np.concatenate([store.span_block_ids(3), store.span_block_ids(8)])
    vec[ids_a[0], :3] = -0.0              # bit-exact: -0.0 stays -0.0
    n = len(vec)
    # a span on each side of every owner boundary, the last block and one
    # past the store (zero rows: padding, or no owner)
    per = -(-n // WORLD)
    ids_b = np.array(sorted({min(max(b + d, 0), n - 1) for b in
                             range(per, n, per) for d in (-2, -1, 0, 1)})
                     + [n - 1, n + 1], np.int64)
    np.savez(tmp / "store.npz", graph_buf=arrays["graph_buf"], vec_buf=vec,
             meta_table=arrays["meta_table"], n_base=arrays["n_base"],
             ids_a=ids_a, ids_b=ids_b,
             **{f"spec_{k}": v for k, v in arrays["spec"].items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(tmp)],
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env())
             for r in range(WORLD)]
    for p in ranks + [ref]:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "store.npz"),
            [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)],
            np.load(tmp / "reference.npz"))


def test_fetch_is_bit_equal_to_the_store_on_every_rank(sharded):
    a, ranks, _ = sharded
    n = len(a["vec_buf"])
    for name in ("ids_a", "ids_b"):
        ids = a[name]
        ok = ids < n
        for r in ranks:
            g, v = r[name + "_g"], r[name + "_v"]
            np.testing.assert_array_equal(g[ok], a["graph_buf"][ids[ok]])
            np.testing.assert_array_equal(v[ok].view(np.int32),
                                          a["vec_buf"][ids[ok]]
                                          .view(np.int32))
            assert not g[~ok].any() and not v[~ok].view(np.int32).any()
    assert np.signbit(ranks[0]["ids_a_v"][0, :3]).all()


def test_one_collective_per_fetch_and_its_bytes(sharded):
    a, ranks, _ = sharded
    row = (a["graph_buf"].shape[1] + a["vec_buf"].shape[1]) * 4
    for r in ranks:
        assert int(r["ids_a_calls"]) == int(r["ids_b_calls"]) == 1
        assert int(r["fetches"]) == 2
        assert int(r["operand_bytes"]) == row * (len(a["ids_a"])
                                                 + len(a["ids_b"]))


def test_shards_partition_the_padded_store(sharded):
    a, ranks, _ = sharded
    n = len(a["graph_buf"])
    per = int(ranks[0]["per_shard"])
    assert per * WORLD == int(ranks[0]["n_blocks"]) >= n
    whole = np.concatenate([r["shard_graph"] for r in ranks])
    np.testing.assert_array_equal(whole[:n], a["graph_buf"])
    assert not whole[n:].any()


def test_matches_the_reference_sharded_store(sharded):
    a, ranks, ref = sharded
    for r in ranks:
        for key in ("n_blocks", "per_shard"):
            assert int(r[key]) == int(ref[key]), key
        np.testing.assert_array_equal(r["owners"], ref["owners"])
        np.testing.assert_array_equal(r["owner_of"], ref["owner_of"])
        for name in ("ids_a", "ids_b"):
            np.testing.assert_array_equal(r[name + "_g"], ref[name + "_g"])
            np.testing.assert_array_equal(r[name + "_v"], ref[name + "_v"])


def test_chip_smoke_sharded_store_phase_on_cpu(capsys):
    """``chip_smoke.py``'s phase 16 on the CPU: its rank processes (gloo
    over CPU tensors here) fetch bit-equal rows with one collective a
    fetch."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    ds = sift_like(n=1500, n_queries=4, seed=1)
    meta = build_meta(ds.data, 12, seed=0)
    store = build_store(ds.data, meta)
    ids = np.concatenate([store.span_block_ids(3), store.span_block_ids(8)])
    cs.phase_sharded_store(store, ids, torch.device("cpu"), world=WORLD,
                           iters=2)
    out = capsys.readouterr().out
    assert f"gloo, {WORLD} rank(s) on cpu: {len(ids)} blocks a fetch" in out
    assert "bit-equal to the store's rows on every rank" in out


# ------------------------------------------------- gradient compression

COMPRESS_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.compression import (
    compressed_grad_reduce, init_error_state)
rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                        world_size=%(world)d, rank=rank)
a = np.load(f"{tmp}/grads.npz")
calls = []
real = dist.all_reduce
dist.all_reduce = lambda *x, **k: calls.append(k.get("op")) or real(*x, **k)
err = init_error_state({"w": torch.zeros(a["w1"].shape[1:]),
                        "b": torch.zeros(a["b1"].shape[1:])})
out = {}
for s in (1, 2):
    g = {"w": torch.from_numpy(a[f"w{s}"][rank]),
         "b": torch.from_numpy(a[f"b{s}"][rank])}
    ghat, err = compressed_grad_reduce(g, err)
    for k in ("w", "b"):
        out[f"g{k}{s}"] = ghat[k].numpy()
        out[f"e{k}{s}"] = err.residual[k].numpy()
out["ops"] = np.array([str(c) for c in calls])
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.destroy_process_group()
""" % {"world": WORLD}

COMPRESS_REFERENCE = """
import sys, numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.core.distributed import shard_map_compat
from repro.distributed.compression import ErrorState, compressed_grad_reduce
tmp = sys.argv[1]
a = np.load(f"{tmp}/grads.npz")
mesh = jax.make_mesh((%(world)d,), ("data",))

def red(w, b, ew, eb):
    g, new = compressed_grad_reduce({"w": w[0], "b": b[0]},
                                    ErrorState({"w": ew[0], "b": eb[0]}),
                                    mesh)
    return (g["w"], g["b"], new.residual["w"][None],
            new.residual["b"][None])
f = jax.jit(shard_map_compat(red, mesh=mesh, in_specs=(P("data"),) * 4,
                             out_specs=(P(), P(), P("data"), P("data"))))
ew, eb = np.zeros_like(a["w1"]), np.zeros_like(a["b1"])
out = {}
for s in (1, 2):
    gw, gb, ew, eb = f(a[f"w{s}"], a[f"b{s}"], ew, eb)
    out.update({f"gw{s}": np.asarray(gw), f"gb{s}": np.asarray(gb),
                f"ew{s}": np.asarray(ew), f"eb{s}": np.asarray(eb)})
np.savez(f"{tmp}/reference.npz", **out)
""" % {"world": WORLD}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """Two steps of ``compressed_grad_reduce`` (error feedback carried)
    on 4 gloo ranks and on the JAX package's 4-device host mesh, on the
    same seeded local grads: (grads, each rank's results, the
    reference's)."""
    tmp = tmp_path_factory.mktemp("compress")
    rng = np.random.default_rng(0)
    grads = {f"{k}{s}": (rng.standard_normal((WORLD,) + shp) * sc).astype(
        np.float32) for s in (1, 2) for k, shp, sc in (
            ("w", (64, 32), 1.0), ("b", (17,), 1e-3))}
    grads["b1"][2, 5] = 0.5          # one rank holds the shared absmax
    np.savez(tmp / "grads.npz", **grads)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(COMPRESS_REFERENCE),
         str(tmp)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}"))
    ranks = [subprocess.Popen(
        [sys.executable, "-c", COMPRESS_RANK, str(r), str(tmp)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(WORLD)]
    for p in ranks + [ref]:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return (grads, [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)],
            np.load(tmp / "reference.npz"))


def test_compressed_reduce_equals_the_reference_bit_for_bit(compressed):
    """Every rank's dequantized mean and its own residual, both steps,
    equal the JAX package's on the host mesh bit for bit: the shared
    absmax is a max (exact), the scale one f32 division on both sides,
    round half to even on both, the int32 sum exact, and the dequantize
    the same two f32 operations in the same order."""
    _, ranks, ref = compressed
    for r, got in enumerate(ranks):
        for s in (1, 2):
            for k in ("w", "b"):
                np.testing.assert_array_equal(got[f"g{k}{s}"],
                                              ref[f"g{k}{s}"])
                np.testing.assert_array_equal(got[f"e{k}{s}"],
                                              ref[f"e{k}{s}"][r])


def test_compressed_reduce_is_the_mean_within_the_reference_bound(
        compressed):
    """The int8 mean within 5 % of the largest |f32 mean| (the bound of
    ``tests/test_distributed.py``'s compression test), two collectives a
    leaf (MAX, then SUM), and each rank's residual within half a
    quantization step of the shared scale."""
    grads, ranks, _ = compressed
    for k in ("w", "b"):
        want = grads[f"{k}1"].mean(0)
        got = ranks[0][f"g{k}1"]
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05
        scale = np.abs(grads[f"{k}1"]).max() / 127
        for out in ranks:
            assert np.abs(out[f"e{k}1"]).max() <= scale * (0.5 + 1e-5)
    ops = [str(o).rsplit(".", 1)[1] for o in ranks[0]["ops"]]
    assert ops == ["MAX", "SUM"] * 4          # 2 leaves x 2 steps


def test_quantize_and_wire_bytes_match_reference(rng):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.distributed import compression as JC
    from repro_torch.distributed import compression as C
    g = (rng.standard_normal((40, 9)) * 0.3).astype(np.float32)
    g[3, 4] = 127.5 * np.abs(g).max() / 127.0    # a tie to round
    q, s = C.quantize(torch.from_numpy(g))
    jq, js = JC.quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize(q, s).numpy(),
                                  np.asarray(JC.dequantize(jq, js)))
    e = np.full_like(g, 0.01)
    tq, ts, tt = C.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    jq2, js2, jt = JC.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    tree = {"a": torch.zeros(10, 3), "b": {"c": torch.zeros(7)}}
    assert C.wire_bytes_saved(tree) == JC.wire_bytes_saved(
        {"a": jnp.zeros((10, 3)), "b": {"c": jnp.zeros(7)}})
    err = C.init_error_state(tree)
    assert all(t.dtype == torch.float32 and not t.any()
               for t in [err.residual["a"], err.residual["b"]["c"]])

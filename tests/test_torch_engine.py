"""The port end to end against the JAX package, on the CPU.

An index is built once by the JAX package (the shared ``built_engine``
fixture: n=4000, n_rep=32, seed 3) and carried across with
``repro_torch.convert``; both engines then search the same state with the
same config.  Host-computed stats (ledger, rounds, pairs, cache hits,
fetches) must be exactly equal; gids equal except at reference ties
within f32 tolerance; distances within rtol 1e-5, atol 1e-4 (the two
sides sum squares in a different order).

Also here: the port's own host build is byte-identical to the
reference's, the package never imports JAX or ``repro``, the card is
never faked, and ``chip_smoke.py``'s phases run at a tiny size on the
CPU with the plain versions.
"""
import dataclasses
import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lm_parity import one_thread  # noqa: E402,F401
from repro_torch import DHNSWEngine, EngineConfig, convert  # noqa: E402
from repro_torch.kernels.quant_topk.ref import ids_agree_up_to_ties  # noqa: E402

# one torch thread: under a parallel run (workers sharing the cores) a
# pool of threads a process spends most of its time waiting
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-4
STAT_KEYS = ("net", "n_rounds", "n_pairs", "cache_hits", "n_fetches")
BASE = dict(n_rep=32, ef=48, seed=3)

CASES = [dict(mode=m, search_mode=s, b=4, cache_frac=0.25)
         for m in ("naive", "no_doorbell", "full") for s in ("graph", "scan")]
CASES += [dict(mode="full", search_mode="scan", b=6, quant="int8",
               quant_kernel=qk, cache_frac=0.6, exact_frac=0.25, doorbell=16)
          for qk in ("auto", "ref")]
# int8 through the per-pair stage 1: quant_kernel "off", and "auto" where
# the quantized tier is not dense-resident (the reference routes it there)
CASES += [dict(mode=m, search_mode=s, b=6, quant="int8", quant_kernel="off",
               cache_frac=0.25, exact_frac=0.25, doorbell=16)
          for m in ("naive", "no_doorbell", "full") for s in ("graph", "scan")]
CASES += [dict(mode="full", search_mode="scan", b=6, quant="int8",
               quant_kernel="auto", cache_frac=0.25, exact_frac=0.25,
               doorbell=16)]


@pytest.fixture(scope="module")
def jax_pkg():
    pytest.importorskip("jax")
    import repro.core as RC
    return RC


def _port_state(built_engine):
    return convert.state_from_numpy(*convert.numpy_state(
        built_engine.meta, built_engine.store))


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    str(kw.get(x, "")) for x in ("mode", "search_mode", "quant_kernel",
                                 "cache_frac")))
def test_search_matches_reference(jax_pkg, built_engine, sift_small, kw):
    ref = jax_pkg.DHNSWEngine(jax_pkg.EngineConfig(**BASE, **kw))
    ref.client.adopt_built(built_engine.meta,
                           dataclasses.replace(built_engine.store),
                           sift_small.data)
    meta, store = _port_state(built_engine)
    eng = DHNSWEngine(EngineConfig(**BASE, **kw), device="cpu")
    eng.adopt_built(meta, store, sift_small.data)
    # two batches: the second one starts from the caches the first left
    for q in (sift_small.queries, sift_small.queries[::-1]):
        dr, gr, sr = ref.search(q, k=10)
        dt, gt, st = eng.search(q, k=10)
        for key in STAT_KEYS:
            assert st[key] == sr[key], key
        if kw.get("quant") == "int8":
            # the flat route names its stage 1; the per-pair route names
            # none, in both packages
            assert ("stage1_impl" in st) == ("stage1_impl" in sr)
            if "stage1_impl" in sr:
                assert st["stage1_impl"] == "ref"
            for key in ("rerank_rows", "rerank_hit_rows", "exact_admitted",
                        "flat_rows", "quant_kernel"):
                assert st.get(key) == sr.get(key), key
        assert gt.dtype == gr.dtype == np.int64
        assert dt.dtype == dr.dtype == np.float32
        ext_d = np.concatenate([dr, np.full((len(dr), 1), np.inf)], 1)
        ext_g = np.concatenate([gr, np.full((len(gr), 1), -1)], 1)
        ok, n_diff = ids_agree_up_to_ties(gt, ext_g, ext_d, rtol=RTOL)
        assert ok, f"{n_diff} gids differ beyond ties"
        np.testing.assert_allclose(dt, dr, rtol=RTOL, atol=ATOL)


def test_port_build_is_byte_identical(built_engine, sift_small):
    """The port's own host build gives the reference's buffers and meta
    graph byte for byte (same data, same seed), int8 mirror included."""
    pytest.importorskip("jax")
    from repro.core import layout as RLA

    from repro_torch.core import layout as LA
    from repro_torch.core import meta as ME
    from repro_torch.core.hnsw import HNSWParams
    cfg = EngineConfig(**BASE)
    meta = ME.build_meta(sift_small.data, cfg.n_rep, seed=cfg.seed,
                         meta_levels=cfg.meta_levels)
    store = LA.build_store(sift_small.data, meta, sub_params=HNSWParams(
        M=max(cfg.sub_M0 // 2, 2), M0=cfg.sub_M0,
        ef_construction=cfg.ef_construction))
    rm, rs = built_engine.meta, built_engine.store
    for a in ("reps", "rep_ids", "assignments"):
        np.testing.assert_array_equal(getattr(meta, a), getattr(rm, a))
    for a in ("vectors", "adjacency", "node_level"):
        got, want = getattr(meta.graph, a), getattr(rm.graph, a)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (meta.graph.entry, meta.graph.n_levels) == (rm.graph.entry,
                                                       rm.graph.n_levels)
    assert dataclasses.asdict(store.spec) == dataclasses.asdict(rs.spec)
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        got, want = getattr(store, a), getattr(rs, a)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), a
    q = LA.attach_quant_mirror(dataclasses.replace(store), 32)
    r = RLA.attach_quant_mirror(dataclasses.replace(rs), 32)
    assert q.qvec_buf.tobytes() == r.qvec_buf.tobytes()
    assert q.qscale_buf.tobytes() == r.qscale_buf.tobytes()
    flat_t, flat_r = LA.flat_quant_rows(q), RLA.flat_quant_rows(r)
    for a, b in zip(flat_t, flat_r):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip(built_engine):
    meta, store = _port_state(built_engine)
    ma, sa = convert.numpy_state(meta, store)
    m2, s2 = convert.state_from_numpy(ma, sa)
    assert s2.spec == store.spec and s2.qvec_buf is None
    assert m2.graph.vectors.tobytes() == meta.graph.vectors.tobytes()
    assert s2.graph_buf.tobytes() == store.graph_buf.tobytes()


# ------------------------------------------------------------ isolation

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                     re.M)


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "benchmarks").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_cpu_search_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch import DHNSWEngine, EngineConfig\n"
        "from repro_torch.data.synthetic import sift_like\n"
        "ds = sift_like(n=600, n_queries=8, seed=1)\n"
        "for kw in (dict(search_mode='graph', use_gather_kernel=True),\n"
        "           dict(search_mode='scan', quant='int8',\n"
        "                quant_kernel='auto', cache_frac=0.6),\n"
        "           dict(search_mode='graph', quant='int8',\n"
        "                quant_kernel='off', cache_frac=0.25)):\n"
        "    e = DHNSWEngine(EngineConfig(n_rep=8, b=2, **kw),\n"
        "                    device='cpu').build(ds.data)\n"
        "    d, g, st = e.search(ds.queries, k=5)\n"
        "    assert g.shape == (8, 5)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cpu_serve_loads_no_jax_and_no_reference():
    """RAG serving through the port (configs, models, the decode route,
    the batcher and server) on the CPU imports neither."""
    code = (
        "import sys\n"
        "from repro_torch import DHNSWEngine, EngineConfig\n"
        "from repro_torch.configs.registry import smoke_config\n"
        "from repro_torch.serve.engine import (RagServeEngine,\n"
        "                                      synthetic_doc_store)\n"
        "cfg = smoke_config('qwen3-8b')\n"
        "docs = synthetic_doc_store(200, 16, 4, cfg.vocab_size)\n"
        "ret = DHNSWEngine(EngineConfig(n_rep=8, b=2, search_mode='scan',\n"
        "                               use_gather_kernel=True),\n"
        "                  device='cpu').build(docs.embeddings)\n"
        "with RagServeEngine(cfg, ret, docs, max_new_tokens=3,\n"
        "                    device='cpu') as eng:\n"
        "    out, st = eng.serve(docs.tokens[:2])\n"
        "    eng.server.metrics_text()\n"
        "assert out.shape == (2, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ------------------------------------------------------------ no fallback

def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        DHNSWEngine(EngineConfig(n_rep=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        DHNSWEngine(EngineConfig(n_rep=8), device="cuda:0")


@pytest.mark.parametrize("kw", [
    dict(bearer="ib"),
    dict(pool="remote"),
    dict(pool="sharded", n_shards=2, shard_transport="remote",
         endpoints=("localhost:1",)),
], ids=["bearer", "remote-without-endpoints", "shard-endpoints"])
def test_paths_outside_the_slice_raise(kw):
    """The configurations the reference's constructor rejects — a bearer
    other than tcp or loopback, ``pool="remote"`` over tcp without
    endpoints, ``shard_transport="remote"`` over tcp with one endpoint per
    shard missing — raise ``ValueError`` in the port's, before any pool is
    built.  (The name dates from the slices before the remote transport
    was ported.)"""
    with pytest.raises(ValueError, match="bearer|endpoint"):
        DHNSWEngine(EngineConfig(**kw, **BASE), device="cpu")
    pytest.importorskip("jax")
    from repro.core import DHNSWEngine as JEngine
    from repro.core import EngineConfig as JConfig
    with pytest.raises(AssertionError):
        JEngine(JConfig(**kw, **BASE))


# ------------------------------------------------------------ chip_smoke

@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    return cs


def test_chip_smoke_phases_on_cpu(chip_smoke):
    """Every phase that does not need the card, at a tiny size, with the
    plain versions (the kernels' wrappers take them on the CPU)."""
    cs = chip_smoke
    cpu = torch.device("cpu")
    ds, meta, store, qstore = cs.phase_index(1000, 32, 8)
    gathers = cs.main_path_gathers(meta, store, ds.queries, cpu, doorbell=16)
    assert gathers[0] and sum(len(i) for i in gathers[0]) == (
        gathers[1] * store.spec.fetch_blocks)
    pair_gathers = {mode: cs.pair_path_gathers(
        meta, qstore, ds.queries, cpu, doorbell=16, search_mode=mode,
        n_batches=4) for mode in ("scan", "graph")}
    for batches in pair_gathers.values():
        assert len(batches) == 4 and batches[0][0]
        assert all(sum(len(i) for i in ids) == n * store.spec.fetch_blocks
                   for ids, n in batches)
    exact, scan_stats, batches = cs.phase_exact(ds, meta, store, cpu, k=10,
                                                doorbell=16, gathers=gathers)
    assert set(batches) == {"graph", "scan"}
    assert batches["scan"][2] is scan_stats
    q8 = cs.phase_int8(ds, meta, qstore, cpu, k=10, doorbell=16)
    tiny = dict(cs.torch_common.PRESETS["quick"], sift_n=1000, n_queries=32,
                batch=32, n_rep=8)
    tp = cs.phase_throughput(ds, meta, store, cpu, preset=tiny,
                             scan_stats=scan_stats)
    pairs = cs.phase_int8_pairs(ds, meta, qstore, cpu, k=10, doorbell=16,
                                gathers=pair_gathers, n_batches=4)
    assert exact == {"gather_blocks": 0, "beam_walk": 0}
    assert q8 == {"quant_topk": 0}
    assert cs.phase_walk(ds, meta, store, cpu, k=10, doorbell=16,
                         graph_batch=batches["graph"]) == []
    assert tp == {"distance_topk": 0} and pairs == {"gather_blocks": 0}
    # phase 9 at the smoke width of qwen3-8b, with the full path's shape
    # of a request (S = 4 * 240 + 64 = 1024: prefill through flash)
    from repro_torch.configs.registry import smoke_config
    rag, rag_gathers, first = cs.phase_rag(
        ds, meta, store, cpu, cfg=smoke_config(cs.RAG_ARCH), doorbell=16,
        **cs.RAG)
    assert all(n == 0 for n in rag.values())
    assert len(rag_gathers) == cs.RAG["n_calls"] and rag_gathers[0][0]
    q, k, v, pos = first
    assert q.shape[0] == cs.RAG["batch"] and k.shape[1] == 1024 + 32
    assert (pos == 1025).all()

    planned = cs.gather_launches(gathers, pair_gathers, rag_gathers)
    # one launch per span read, over all of its staged buffers
    assert {b for b, _ in planned} == {("graph", "vec"),
                                       ("graph", "codes", "scales")}
    assert len(planned) == 2 * len(gathers[0]) + sum(
        len(ids) for batches in pair_gathers.values()
        for ids, _ in batches) + sum(len(ids) for ids, _ in rag_gathers)
    long = cs.long_decode_inputs(B=2, S=300, H=q.shape[1], K=k.shape[2],
                                 hd=q.shape[2], dtype=q.dtype, device=cpu)
    recs = cs.phase_kernels(store, qstore, ds.data, ds.queries, planned, cpu,
                            decode_shapes=[("path", q, k, v, pos),
                                           ("long", *long)])
    assert [r["name"] for r in recs] == ["gather_blocks", "quant_topk",
                                         "distance_topk", "decode_attention"]
    assert all(r["ms"] is None and r["bound_ms"] > 0 for r in recs)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(set(r) == keys for r in recs)
    assert all((ROOT / r["source"]).exists() for r in recs)
    # the profiled decode window's busy time is a union of intervals
    assert cs._busy_us([(5, 6), (0, 2), (1, 3), (5.5, 5.75)]) == 4.0


def test_chip_smoke_insert_and_load_phases_on_cpu(chip_smoke):
    """Phases 10 (insert) and 11 (bulk load) at a tiny size on the CPU:
    every check of theirs runs (gids, verbs, the charge rule, the region
    and flat view against the host and a fresh sync, routing against the
    CPU twin, self-recall, recall, bit-identical streamed build), and the
    gather calls they record become phase 4 launches on named buffers."""
    cs = chip_smoke
    cpu = torch.device("cpu")
    ds, meta, store, qstore = cs.phase_index(1000, 32, 8)
    vec0 = store.vec_buf.copy()
    _, scan, _ = cs.phase_exact(ds, meta, store, cpu, k=10, doorbell=16,
                                gathers=cs.main_path_gathers(
                                    meta, store, ds.queries, cpu,
                                    doorbell=16))
    ins, rec, bufs = cs.phase_insert(ds, meta, store, qstore, cpu, k=10,
                                     doorbell=16,
                                     scan_recall=scan["recall_at_k"],
                                     n_held=16)
    assert np.array_equal(store.vec_buf, vec0)     # worked on copies
    assert all(n == 0 for n in ins.values())      # plain versions here
    assert rec and set(bufs) == {n for b, _ in rec for n in b}
    load, rec2, bufs2 = cs.phase_load(cpu, n=1600, n_rep=12, n_chunks=8,
                                      n_queries=16, k=10, doorbell=16)
    assert all(n == 0 for n in load.values()) and rec2
    assert len({b for b, _ in rec2}) == 2           # one per engine
    planned = cs.gather_launches(([], 0), {}, (), rec + rec2)
    assert planned == rec + rec2
    gather = cs._gather_record({**bufs, **bufs2}, planned, cpu, timed=False)
    assert gather["bound_ms"] > 0 and gather["max_abs_err"] == 0.0


def test_chip_smoke_pool_phases_on_cpu(chip_smoke, capsys):
    """Phases 12 (the multi-node pools) and 13 (the serving benchmark) on
    the CPU, at ``benchmarks/torch_pool.py``'s smoke geometry (1500 rows,
    12 partitions, 2 shards, 12 zipf batches of 32): every check of theirs
    runs (12d's five benchmark tables, the two that fork pool servers
    among them), the shard rows equal the smoke baseline's, and the gather calls
    they record become phase 4 launches on named buffers."""
    cs = chip_smoke
    cpu = torch.device("cpu")
    ds, meta, store, qstore = cs.phase_index(1500, 64, 12)
    vec0 = store.vec_buf.copy()
    pools = cs.PathLog(cpu)
    cs.phase_sim_rdma(ds, meta, store, qstore, cpu, k=10, doorbell=16,
                      log_=pools)
    cs.phase_sharded(ds, meta, store, qstore, cpu, k=10, doorbell=16,
                     n_shards=2, n_batches=12, per_batch=32,
                     migrate_every=32, log_=pools)
    cs.phase_failover(ds, meta, store, cpu, k=10, doorbell=16, log_=pools)
    assert np.array_equal(store.vec_buf, vec0)     # inserts on copies
    out = capsys.readouterr().out
    assert "sim 26.628 us/q" in out and "sim 13.513 us/q" in out
    assert "staged MB [1.225, 1.225]" in out and "[2.45, 1.225]" in out
    n12 = len(pools.calls)
    assert n12 > 0
    def boom(*_):
        raise TimeoutError("phase 12d ran past 240 s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(240)                      # 12d forks four pool servers
    try:
        cs.phase_pool_bench(cpu, pools)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    n12d = len(pools.calls)
    cs.phase_serving(cpu, "cpu", pools)
    # both benchmarks read their spans through the gather's wrapper
    assert n12 < n12d < len(pools.calls)
    assert all(n == 0 for n in pools.launches.values())
    bufs = {}
    rec = cs.recorded_launches(pools.calls, bufs, "pool.")
    gather = cs._gather_record(bufs, rec, cpu, timed=False)
    assert gather["bound_ms"] > 0 and gather["max_abs_err"] == 0.0


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No result line without CUDA, in the checkout and alone."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

"""The port's serving tier (``repro_torch.serve``) on the CPU: twins of
``tests/test_serve.py``, the port's ``RagServeEngine`` against the JAX
package's on the same index, LM weights, documents and prompts, and the
framework-free copies held to their originals.

Parity runs in f32 (``dtype="float32"``): the retrieved doc ids and the
retrieval's counted network stats are exactly equal (both sides embed a
prompt with numpy's mean of the same f32 rows and search the same
index), and the generated tokens are equal (greedy argmax over logits
that agree to ~1e-5, see ``tests/test_torch_models.py``).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig, convert  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.serve.engine import (RagServeEngine,  # noqa: E402
                                      synthetic_doc_store)
from repro_torch.serve.server import SearchServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RET = dict(n_rep=12, b=2, ef=16, cache_frac=0.4)


@pytest.fixture(scope="module")
def rag():
    cfg = smoke_config("phi3-mini-3.8b")
    docs = synthetic_doc_store(300, 32, doc_len=4, vocab=cfg.vocab_size)
    ret = DHNSWEngine(EngineConfig(**RET), device="cpu").build(
        docs.embeddings)
    eng = RagServeEngine(cfg, ret, docs, max_new_tokens=4, device="cpu")
    yield eng, docs
    eng.close()


# ------------------------------------------------- twins of test_serve.py

def test_serve_shapes_and_finiteness(rag):
    eng, docs = rag
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, eng.cfg.vocab_size, (3, 8)).astype(np.int32)
    out, stats = eng.serve(prompts)
    assert out.shape == (3, 4)
    assert (out >= 0).all() and (out < eng.cfg.vocab_size).all()
    assert stats.retrieval["net"]["round_trips"] >= 1


def test_serve_retrieval_is_batched(rag):
    """Two identical prompts must not double-fetch partitions."""
    eng, docs = rag
    rng = np.random.default_rng(1)
    p = rng.integers(0, eng.cfg.vocab_size, (1, 8)).astype(np.int32)
    prompts = np.concatenate([p, p, p, p])
    out, stats = eng.serve(prompts)
    r = stats.retrieval
    # unique fetches <= distinct partitions needed by ONE prompt * b
    assert r["n_fetches"] <= eng.retriever.cfg.b
    assert np.array_equal(out[0], out[1])


def test_deterministic_generation(rag):
    eng, docs = rag
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, eng.cfg.vocab_size, (2, 6)).astype(np.int32)
    out1, _ = eng.serve(prompts)
    out2, _ = eng.serve(prompts)
    assert np.array_equal(out1, out2)


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("arch", ["qwen3-8b", "phi3-mini-3.8b",
                                  "qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_rag_serve_matches_reference(arch):
    pytest.importorskip("jax")
    import jax

    from repro.configs.registry import smoke_config as jsmoke
    from repro.core import DHNSWEngine as JEngine
    from repro.core import EngineConfig as JConfig
    from repro.serve.engine import RagServeEngine as JRag

    jcfg = jsmoke(arch).replace(dtype="float32")
    cfg = smoke_config(arch).replace(dtype="float32")
    docs = synthetic_doc_store(300, 32, doc_len=4, vocab=cfg.vocab_size)
    jret = JEngine(JConfig(**RET)).build(docs.embeddings)
    meta, store = convert.state_from_numpy(*convert.numpy_state(
        jret.meta, jret.store))
    ret = DHNSWEngine(EngineConfig(**RET), device="cpu").adopt_built(
        meta, store, docs.embeddings)
    with JRag(jcfg, jret, docs, max_new_tokens=5, docs_per_query=3) as je, \
            RagServeEngine(cfg, ret, docs, max_new_tokens=5,
                           docs_per_query=3, device="cpu") as te:
        te.params = convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, je.params), "cpu")
        rng = np.random.default_rng(3)
        for B, Sp in ((4, 8), (3, 11)):
            prompts = rng.integers(0, cfg.vocab_size, (B, Sp)).astype(
                np.int32)
            jout, jst = je.serve(prompts)
            tout, tst = te.serve(prompts)
            assert tst.retrieval["net"] == jst.retrieval["net"]
            for key in ("n_fetches", "cache_hits", "n_rounds", "n_pairs"):
                assert tst.retrieval.get(key) == jst.retrieval.get(key), key
            np.testing.assert_array_equal(tout, jout)
            q = te._embed(prompts)
            np.testing.assert_array_equal(q, je._embed(prompts))
            _, tids, _ = te.server.search(q, k=3)
            _, jids, _ = je.server.search(q, k=3)
            np.testing.assert_array_equal(tids, jids)


def test_rag_serve_of_encdec_raises_as_the_reference():
    """The engine passes no frames, and an encdec prefill needs them: both
    packages raise ``KeyError`` after the retrieval."""
    pytest.importorskip("jax")
    from repro.core import DHNSWEngine as JEngine
    from repro.core import EngineConfig as JConfig
    from repro.serve.engine import RagServeEngine as JRag

    cfg = smoke_config("whisper-tiny").replace(dtype="float32")
    docs = synthetic_doc_store(300, 32, doc_len=4, vocab=cfg.vocab_size)
    prompts = np.zeros((2, 5), np.int32)
    with JRag(cfg, JEngine(JConfig(**RET)).build(docs.embeddings), docs,
              max_new_tokens=2) as je:
        with pytest.raises(KeyError, match="frames"):
            je.serve(prompts)
    with RagServeEngine(cfg, DHNSWEngine(EngineConfig(**RET), device="cpu")
                        .build(docs.embeddings), docs, max_new_tokens=2,
                        device="cpu") as te:
        with pytest.raises(KeyError, match="frames"):
            te.serve(prompts)


def test_rag_serve_needs_a_card_unless_asked_for_the_cpu(rag):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    eng, docs = rag
    with pytest.raises(RuntimeError, match="CUDA"):
        RagServeEngine(eng.cfg, SearchServer(eng.retriever,
                                             autostart=False), docs)


def test_insert_through_the_batcher_raises(rag):
    """An insert request through the serving tier (``SearchServer`` ->
    ``MicroBatcher`` -> the engine's insert) returns the gids the JAX
    package's serving tier returns for the same request, and a search
    fused after it finds the inserted vectors, as the reference's does.
    (The name dates from the slices before insert was ported.)"""
    pytest.importorskip("jax")
    import repro.core as RC
    from repro.serve.server import SearchServer as RServer
    eng, docs = rag
    new = docs.embeddings[:3] + 0.001
    servers = (SearchServer(DHNSWEngine(EngineConfig(**RET), device="cpu")
                            .build(docs.embeddings)),
               RServer(RC.DHNSWEngine(RC.EngineConfig(**RET))
                       .build(docs.embeddings)))
    try:
        gids = [s.insert(new) for s in servers]
        np.testing.assert_array_equal(gids[0], gids[1])
        np.testing.assert_array_equal(
            gids[0], np.arange(len(docs.embeddings),
                               len(docs.embeddings) + 3))
        hits = [s.search(new, k=3)[1] for s in servers]
        np.testing.assert_array_equal(hits[0], hits[1])
        assert all(int(g) in hits[0][i] for i, g in enumerate(gids[0]))
    finally:
        for s in servers:
            s.stop()


# ------------------------------------------------- the framework-free copies

COPIES = ([f"configs/{p.name}" for p in
           sorted((ROOT / "src/repro/configs").glob("*.py"))]
          + ["obs/hist.py", "obs/slo.py", "obs/metrics.py",
             "serve/batcher.py", "serve/server.py", "ingest/loader.py",
             "ingest/compactor.py", "obs/report.py", "pool/placement.py",
             "net/wire.py", "net/server.py", "ingest/wal.py",
             "ingest/checkpoint.py"]
          + [f"rdma/{p.name}" for p in
             sorted((ROOT / "src/repro/rdma").glob("*.py"))])
# beyond the imports, what ``net/server.py`` needs to spawn the port's own
# server: ``_src_path`` imports and measures the port's package, and the
# spawned module is the port's
SERVER_REWRITES = (("    import repro\n", "    import repro_torch\n"),
                   ("repro.__file__", "repro_torch.__file__"),
                   ("repro.__path__", "repro_torch.__path__"),
                   ('"repro.net.server"', '"repro_torch.net.server"'))


@pytest.mark.parametrize("rel", COPIES)
def test_copies_are_the_originals_with_imports_rewritten(rel):
    orig = (ROOT / "src/repro" / rel).read_text()
    port = (ROOT / "src/repro_torch" / rel).read_text()
    want = orig.replace("from repro.", "from repro_torch.").replace(
        'import_module(f"repro.', 'import_module(f"repro_torch.')
    if rel == "net/server.py":
        for old, new in SERVER_REWRITES:
            assert old in want, old
            want = want.replace(old, new)
    assert port == want


def test_configs_behave_as_the_originals():
    from repro.configs import base as JB
    from repro.configs import registry as JR

    from repro_torch.configs import base as B
    from repro_torch.configs import registry as R
    assert R.ARCH_IDS == JR.ARCH_IDS
    for a in R.ARCH_IDS:
        for fn in ("get_config", "smoke_config"):
            c, jc = getattr(R, fn)(a), getattr(JR, fn)(a)
            assert dataclasses.asdict(c) == dataclasses.asdict(jc)
            assert c.param_count() == jc.param_count()
            assert c.param_count(True) == jc.param_count(True)
    assert R.all_cells() == JR.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in B.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}


def test_obs_copies_behave_as_the_originals():
    from repro.obs import hist as JH
    from repro.obs import metrics as JM
    from repro.obs import slo as JS

    from repro_torch.obs import hist as H
    from repro_torch.obs import metrics as M
    from repro_torch.obs import slo as S
    rng = np.random.default_rng(0)
    xs = rng.lognormal(-8, 2, 500)
    h, jh = H.LatencyHistogram(), JH.LatencyHistogram()
    for x in xs:
        h.record(float(x))
        jh.record(float(x))
    assert h.to_dict() == jh.to_dict()
    assert [h.quantile(q) for q in (0.5, 0.9, 0.99)] == [
        jh.quantile(q) for q in (0.5, 0.9, 0.99)]
    spec = "p99<5ms"
    assert dataclasses.asdict(S.parse_slo(spec)) == dataclasses.asdict(
        JS.parse_slo(spec))
    snap = {"requests": 3, "p50_s": 1e-3, "net": {"round_trips": 2,
                                                  "bytes": 10.0}}
    assert M.render_prometheus(snap) == JM.render_prometheus(snap)


def test_search_server_copy_matches_reference(built_engine, sift_small):
    """The port's SearchServer over the port's engine and the reference's
    over the reference's, on one index and one request sequence: equal
    gids and an equal rolled-up ``net`` in ``stats()``."""
    from repro.core import DHNSWEngine as JEngine
    from repro.core import EngineConfig as JConfig
    from repro.serve.server import SearchServer as JServer

    kw = dict(mode="full", search_mode="graph", n_rep=32, b=4, ef=48,
              cache_frac=0.25, seed=3)
    meta, store = convert.state_from_numpy(*convert.numpy_state(
        built_engine.meta, built_engine.store))
    port = DHNSWEngine(EngineConfig(**kw), device="cpu").adopt_built(
        meta, store, sift_small.data)
    ref = JEngine(JConfig(**kw))
    ref.client.adopt_built(built_engine.meta,
                           dataclasses.replace(built_engine.store),
                           sift_small.data)
    with SearchServer(port) as ts, JServer(ref) as js:
        for lo, hi in ((0, 5), (5, 6), (6, 30)):
            _, tg, _ = ts.search(sift_small.queries[lo:hi], k=5)
            _, jg, _ = js.search(sift_small.queries[lo:hi], k=5)
            np.testing.assert_array_equal(tg, jg)
        assert ts.stats()["net"] == js.stats()["net"]
        for key in ("n_requests", "n_queries", "n_fused_calls"):
            assert ts.stats()[key] == js.stats()[key], key

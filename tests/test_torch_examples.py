"""The torch twins of ``examples/*.py`` (``examples/torch_*.py``), each in
a subprocess on CPU tensors (``--device cpu``) at its smallest
arguments: each exits 0 and prints its reference's lines;
``torch_quickstart.py`` prints, at the same seed, every line that
``examples/quickstart.py`` prints (none of them reads a clock: store MB
and blocks, meta MB, recall@10, round trips and modeled us a query, the
inserted share found, cache hits and fetches).  Without ``--device``
each twin asks for the card and, with none here, exits with torch's
"no CUDA device" error (no fallback).  ``repro_torch.core`` exports
every name of the reference's ``repro.core``."""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart", "rag_serve", "train_lm", "live_ingest",
         "online_serving", "distributed_search")


def _env(**extra):
    path = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(path), **extra)


def _run(script: str, *args, timeout: float = 300):
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          capture_output=True, text=True, env=_env(),
                          timeout=timeout)


def _lines(out) -> list:
    return [line.rstrip() for line in out.stdout.splitlines()
            if line.strip()]


@pytest.fixture(scope="module")
def quickstarts():
    """The reference quickstart (JAX on the CPU) and the port's twin, run
    at the same time."""
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run, "quickstart.py")
        port = pool.submit(_run, "torch_quickstart.py", "--device", "cpu")
        return ref.result(), port.result()


def test_quickstart_prints_the_reference_lines(quickstarts):
    ref, port = quickstarts
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    want, got = _lines(ref), _lines(port)
    print("\n".join(got))
    assert len(want) == 11
    assert got == want


SMALL = {
    "rag_serve": ("--n-docs", "200", "--batch", "2"),
    "train_lm": ("--steps", "2", "--batch", "1", "--seq", "16",
                 "--ckpt-dir", ""),
    "live_ingest": ("--n", "2000", "--ingest", "64", "--seconds", "0.2"),
    "online_serving": ("--clients", "2", "--requests", "2", "--n", "2000"),
    "distributed_search": (),
}
# what each twin must print (its reference's lines; the distributed
# search's are the reference's own output, which reads no clock)
EXPECT = {
    "rag_serve": ("arch: qwen3-8b (reduced: 2L d=64)",
                  "indexing 200 docs in d-HNSW...",
                  "serving batch of 2 prompts...",
                  "  decode:", "(8 tokens/seq)",
                  "  generated token ids, first sequence: ["),
    "train_lm": ("arch qwen3-8b: ~", "2 steps @ batch 1 x seq 16",
                 "step     0  loss ", "loss: first10=", "mean step time: ",
                 "checkpoints in  (restart-safe: rerun resumes)"),
    "live_ingest": ("indexing 2000 rows (64 held out for live ingest)...",
                    "before ingest: recall@10 ", "during ingest: recall@10 ",
                    "after ingest:  recall@10 ",
                    "includes the 64 inserted rows)", "insert wire: "),
    "online_serving": ("indexing 2000 vectors...",
                       "2 clients x 2 requests, one request per engine "
                       "call (no batching):",
                       "same load through the micro-batcher:",
                       "  speedup x", "  stage breakdown", "  network: "),
    "distributed_search": (
        "devices: 8",
        "store: 576 blocks sharded over 4 memory instances (144 blocks "
        "each)",
        "doorbell fetch of partitions [3, 10, 17]: one collective launch, "
        "60 blocks, correct=True",
        "partition->owner map (first 12): [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, "
        "1, 1]",
        "straggler rebalance off owner 2: 8 group moves (each a contiguous "
        "span copy)",
        "elastic 4->6 owners: 6 contiguous moves, 432/576 blocks relocate "
        "(16.0 MB)"),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_twin_runs_on_cpu(name):
    out = _run(f"torch_{name}.py", "--device", "cpu", *SMALL[name])
    assert out.returncode == 0, out.stderr[-3000:]
    print(out.stdout)
    for want in EXPECT[name]:
        assert want in out.stdout, (want, out.stdout)


@pytest.mark.parametrize("name", TWINS)
def test_twin_asks_for_the_card(name):
    """The default device is the card: without one the twin raises (the
    engine's, the trainer's or the launcher's ``resolve_device``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    args = {"train_lm": ("--steps", "1", "--ckpt-dir", ""),
            "rag_serve": ("--n-docs", "50"),
            "live_ingest": ("--n", "600", "--ingest", "8"),
            "online_serving": ("--n", "600")}.get(name, ())
    out = _run(f"torch_{name}.py", *args, timeout=120)
    assert out.returncode != 0
    assert "torch sees no CUDA device" in out.stderr, out.stderr[-2000:]


def test_core_exports_the_reference_names():
    """``repro_torch.core.__all__`` is the reference's, each name bound."""
    pytest.importorskip("jax")
    import repro.core as RC

    import repro_torch.core as TC
    assert list(TC.__all__) == list(RC.__all__)
    for name in TC.__all__:
        assert getattr(TC, name) is not None

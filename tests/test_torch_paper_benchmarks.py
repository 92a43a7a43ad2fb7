"""The port's twins of the paper's evaluation against the JAX package's
benchmarks, on the CPU.

``benchmarks/torch_latency_recall.py`` (Fig. 6), ``torch_breakdown.py``
(Tables 1-2) and ``torch_insert.py`` run at a tiny preset patched into
both packages' presets, in ``benchmarks/run.py``'s order (fig6, tables,
insert) on shared engines, so each engine's span cache carries from one
sweep to the next as in the reference; every counted field of every row
must equal the reference's: ``net_us_q``, ``rtpq``, ``bytes_q``,
``recall`` and the headline rows' network ratios and recall, insert's
``n``, ``net``, ``hit`` and ``self_recall``.  ``torch_headline.py``
prints the reference's lines at a few thousand rows.  The committed
``benchmarks/torch_reference/paper_quick.json`` holds the reference's
rows at the ``quick`` preset, which ``chip_smoke.py`` holds the card to.
Clock fields (``us_per_call``, ``sub_us_q``, ``meta_us_q``, the total
ratio) are never compared.
"""
import contextlib
import io
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from lm_parity import one_thread  # noqa: E402,F401

# the port's runs on one torch thread: under the suite's parallel workers
# a pool of threads a process made the twins ~20x slower
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(sift_n=1000, gist_n=400, n_queries=32, batch=32, n_rep=8,
            efs=(2, 48))
HEADLINE_N = 2000          # rows of the headline run (the reference: 100k)
SUITES = ("fig6", "table", "insert")


def _bench(name: str):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(f"benchmarks.{name}", fromlist=[name])
    finally:
        sys.path.remove(str(ROOT))


def _suite(name: str) -> str:
    return name.split("/")[0]


@pytest.fixture(scope="module")
def reference():
    """The JAX benchmarks' printed rows at ``TINY``, run once as
    ``python -m benchmarks.run fig6 tables insert`` runs them."""
    pytest.importorskip("jax")
    common = _bench("common")
    ref = _bench("torch_paper_reference")
    mods = [_bench(m) for m in ("latency_recall", "breakdown", "insert")]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for key, val in TINY.items():
            mp.setitem(common.P, key, val)
        common.dataset.cache_clear()
        common.engine.cache_clear()
        try:
            with contextlib.redirect_stdout(out):
                for mod in mods:
                    mod.run()
        finally:
            common.dataset.cache_clear()
            common.engine.cache_clear()
    return ref.parse(out.getvalue())


@pytest.fixture(scope="module")
def port(one_thread):
    """The twins' rows at ``TINY`` on CPU tensors, in the same order."""
    common = _bench("torch_common")
    preset = dict(common.PRESETS["quick"], **TINY)
    common.clear()
    try:
        return [row for mod in ("torch_latency_recall", "torch_breakdown",
                                "torch_insert")
                for row in _bench(mod).run(preset=preset, device="cpu")]
    finally:
        common.clear()


@pytest.mark.parametrize("suite", SUITES)
def test_counted_rows_equal_reference(reference, port, suite):
    ref = _bench("torch_paper_reference")
    want = [ref.counted(r) for r in reference if _suite(r["name"]) == suite]
    got = [ref.counted(r) for r in port if _suite(r["name"]) == suite]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert want and got == want


def test_rows_carry_the_reference_fields(reference, port):
    """Every row has the reference's fields (the clock ones too), and the
    twins' loops name the rows the reference printed."""
    assert [r["name"] for r in port] == [r["name"] for r in reference]
    for got, want in zip(port, reference):
        assert set(got) == set(want), got["name"]
    ref = _bench("torch_paper_reference")
    preset = dict(_bench("torch_common").PRESETS["quick"], **TINY)
    names = ref.row_names(preset)
    assert names == [r["name"] for r in reference]


def _headline_lines(text: str) -> list[str]:
    """The counted part of the headline run's lines: each scheme's line
    without its build time, and the ratio line."""
    out = []
    for line in text.splitlines():
        if line.startswith("HEADLINE"):
            out.append(line)
        elif re.match(r"\w+ +build \d+s ", line):
            out.append(re.sub(r"build \d+s ", "", line))
    return out


def test_headline_prints_the_reference_lines(capsys, monkeypatch):
    pytest.importorskip("jax")
    headline_full = _bench("headline_full")
    real = headline_full.sift_like
    monkeypatch.setattr(
        headline_full, "sift_like",
        lambda n, n_queries, seed: real(n=HEADLINE_N, n_queries=n_queries,
                                        seed=seed))
    headline_full.main()
    want = _headline_lines(capsys.readouterr().out)
    res = _bench("torch_headline").run(n=HEADLINE_N, device="cpu")
    got = _headline_lines(capsys.readouterr().out)
    assert len(want) == 4 and got == want
    assert set(res) == {"naive", "no_doorbell", "full"}


def test_run_exits_nonzero_on_a_failing_suite(capsys):
    torch_run = _bench("torch_run")
    assert "roofline" not in torch_run.SUITES
    with pytest.raises(SystemExit) as exc:
        torch_run.main(["--device", "meta", "insert"])
    assert exc.value.code == "failed suites: ['insert']"
    assert "# SUITE FAILED: insert" in capsys.readouterr().out


def test_reference_file_holds_the_quick_rows():
    """``paper_quick.json``: the rows the twins' loops give at the
    ``quick`` preset (no search), the command and the commit that made
    them, and each row's counted fields and nothing else."""
    ref = _bench("torch_paper_reference")
    blob = ref.load()
    assert blob["command"] == ref.COMMAND
    assert re.fullmatch(r"[0-9a-f]{40}", blob["commit"])
    quick = _bench("torch_common").PRESETS["quick"]
    assert [r["name"] for r in blob["rows"]] == ref.row_names(quick)
    for row in blob["rows"]:
        assert set(row) == {"name", *ref.counted_fields(row["name"])}
        assert all(isinstance(v, (int, float)) for k, v in row.items()
                   if k != "name")


def test_chip_smoke_paper_phase_on_cpu(reference):
    """Phase 18 of ``chip_smoke.py`` on CPU tensors at a tiny size: (a) at
    ``TINY`` against the reference's rows, (b) at a tiny full preset whose
    sift is phase 3's index (256 partitions, as at full size), (c) the
    headline run on that index against phase 5's graph batch; the gather
    calls it records become phase 4 launches on named buffers, and the
    gist ones a part of their own."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    n = 4096
    ds, meta, store, _ = cs.phase_index(n, TINY["n_queries"], 256)
    gathers = cs.main_path_gathers(meta, store, ds.queries, cpu, doorbell=16)
    _, _, batches = cs.phase_exact(ds, meta, store, cpu, k=10, doorbell=16,
                                   gathers=gathers)
    quick = dict(cs.torch_common.PRESETS["quick"], **TINY)
    full = dict(quick, sift_n=n, n_rep=256)
    launches, recorded, bufs = cs.phase_paper(
        ds, meta, store, cpu, graph_batch=batches["graph"], quick=quick,
        full=full, reference=reference, recall_floor=0.0)
    assert launches == {name: 0 for name in cs.KERNEL_OPS}
    assert {b for names, _ in recorded for b in names} <= set(bufs)
    tags = {names[0].rsplit(".", 1)[0] for names, _ in recorded}
    assert tags == {f"paper.{t}" for t in (
        "quick.sift", "quick.gist", "quick.insert", "full.sift",
        "full.gist", "headline")}
    gist = [(names, ids) for names, ids in recorded
            if names[0].startswith("paper.full.gist.")]
    assert {bufs[b].shape[1] for names, _ in gist for b in names} == {
        64 * 17, 64 * 960}
    rec = cs._gather_record(bufs, recorded, cpu, timed=False)
    assert rec["bound_ms"] > 0 and rec["max_abs_err"] == 0.0
    cs._gather_part(bufs, gist, "gist", cpu, timed=False)
    assert not cs.torch_common._ENGINES and not cs.torch_common._INDEX


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_phase4_times_the_gather_in_runs_that_fit(monkeypatch):
    """Phase 4 times the gather's launches in consecutive runs whose
    outputs fit in ``GATHER_OUT_BYTES`` (one output per launch), and sums
    the runs' times."""
    cs = _chip_smoke()
    bufs = {"g": torch.zeros(4, 8, dtype=torch.int32),
            "v": torch.zeros(4, 32)}
    ids = [torch.tensor([0, 1]), torch.tensor([2]), torch.tensor([3, 0, 1])]
    launches = [(("g", "v"), i) for i in ids]
    runs = []

    def times(bufs_, run, device):
        runs.append([len(i) for _, i in run])
        return 1.0, 2.0, 3.0
    monkeypatch.setattr(cs, "_gather_run_times", times)
    monkeypatch.setattr(cs, "GATHER_OUT_BYTES", 3 * (8 * 4 + 32 * 4))
    assert cs._gather_times(bufs, launches, "cpu") == (2.0, 4.0, 6.0)
    assert runs == [[2, 1], [3]]


def test_phase18_holds_the_card_to_the_reference(capsys):
    """Phase 18a's comparison: a counted field off raises; a recall off
    by more than one query's share raises; and the queries whose gids
    differ from a CPU run are printed with their distances."""
    cs = _chip_smoke()
    quick = dict(cs.torch_common.PRESETS["quick"], **TINY)
    want = cs.torch_paper_reference.load()["rows"]
    rows = [dict(r) for r in want]
    rows[0]["rtpq"] += 1e-5
    with pytest.raises(AssertionError, match="rtpq"):
        cs._paper_against_reference(rows, {}, quick, want)
    rows = [dict(r) for r in want]
    rows[1]["recall"] -= 0.5
    with pytest.raises(AssertionError, match="one query's share"):
        cs._paper_against_reference(rows, {}, quick, want)
    cs.torch_common.clear()
    try:
        ds = cs.torch_common.dataset("sift", quick)
        queries = cs.torch_common.batched_queries(ds, quick["batch"])
        d, g, _ = cs.torch_common.engine(
            "sift", "full", preset=quick, device="cpu").search(
            queries, k=10, ef=48)
        g = g.copy()
        g[3, 0] = -7
        name = "fig6/sift@top10/full/ef48"
        cs._gid_diff(name, {name: dict(d=d, g=g)}, quick)
    finally:
        cs.torch_common.clear()
    out = capsys.readouterr().out
    assert f"{name} query 3: card gids [-7," in out
    assert out.count(" query ") == 1

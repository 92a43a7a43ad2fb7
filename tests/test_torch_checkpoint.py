"""The port's checkpoints and supervision (``repro_torch.train.checkpoint``,
``trainer``) on the CPU: twins of ``tests/test_train.py``'s checkpoint,
restart and heartbeat tests, and checkpoints crossing between the
packages both ways — the same files, manifest and checksums, equal
leaves on restore."""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lm_parity import one_thread  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train import adamw  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train.trainer import (HeartbeatMonitor,  # noqa: E402
                                       run_with_restarts)

pytestmark = pytest.mark.usefixtures("one_thread")


def _state(arch="mamba2-370m", seed=0):
    params = init_params(M.param_defs(smoke_config(arch)),
                         torch.Generator().manual_seed(seed))
    return params, adamw.init(params)


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _state()
    opt.step.fill_(3)
    CKPT.save(str(tmp_path), 7, (params, opt))
    (p2, o2), step = CKPT.restore(str(tmp_path), (params, opt))
    assert step == 7
    assert isinstance(o2, adamw.AdamWState) and int(o2.step) == 3
    assert o2.step.dtype == torch.int32
    for a, b in zip(T.leaves((params, opt)), T.leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_gc(tmp_path):
    tree = {"w": torch.arange(10.0)}
    for s in (1, 2, 3, 4, 5):
        CKPT.save(str(tmp_path), s, tree, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert CKPT.latest_step(str(tmp_path)) == 5


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"w": torch.arange(10.0)}
    d = CKPT.save(str(tmp_path), 1, tree)
    f = os.path.join(d, "arr_00000.npy")
    data = bytearray(open(f, "rb").read())
    data[-1] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(IOError):
        CKPT.restore(str(tmp_path), tree)


def test_run_with_restarts_recovers(tmp_path):
    """Fault injection: the supervised loop restores and finishes."""
    state = {"x": torch.zeros(())}
    fail_at = {3, 7}

    def step_fn(s, step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError(f"injected failure at {step}")
        return {"x": s["x"] + 1.0}

    final, rep = run_with_restarts(step_fn, state, 10,
                                   ckpt_dir=str(tmp_path), ckpt_every=2)
    assert rep.steps_done == 10
    assert rep.n_restores == 2
    assert float(final["x"]) == 10.0


def test_heartbeat_straggler_detection():
    mon = HeartbeatMonitor(8, z_thresh=2.5)
    for step in range(6):
        for w in range(8):
            t = 1.0 if w != 5 else 3.5   # worker 5 is slow
            mon.beat(w, t, now=float(step))
    assert mon.stragglers() == [5]
    for step in range(6, 9):
        for w in range(8):
            if w != 3:
                mon.beat(w, 1.0, now=float(step) * 5)
    assert 3 in mon.dead(now=100.0)


# --------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from repro.configs import registry as JR
    from repro.models import model as JM
    from repro.models.params import init_params as jinit
    from repro.train import adamw as JA
    from repro.train import checkpoint as JCKPT

    class Ref:
        pass
    r = Ref()
    r.jax, r.CKPT, r.A = jax, JCKPT, JA
    r.params = jinit(JM.param_defs(JR.smoke_config("qwen3-moe-30b-a3b")),
                     jax.random.key(0))
    r.opt = JA.init(r.params)._replace(step=jax.numpy.int32(5))
    return r


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_between_the_packages(jx, tmp_path):
    """The reference's (params, AdamWState) written by each package: the
    same manifest (structure, shapes, dtypes, checksums) and the same
    bytes in every leaf file; each package restores the other's with
    equal leaves."""
    jtree = (jx.params, jx.opt)
    p, o = convert.train_state_from_numpy(
        jx.jax.tree.map(np.asarray, jx.params),
        jx.jax.tree.map(np.asarray, tuple(jx.opt)), device="cpu")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    d_ref = jx.CKPT.save(str(ref_dir), 5, jtree)
    d_port = CKPT.save(str(port_dir), 5, (p, o))
    assert _manifest(d_ref) == _manifest(d_port)
    files = sorted(os.listdir(d_ref))
    assert files == sorted(os.listdir(d_port))
    _, mismatch, errors = filecmp.cmpfiles(d_ref, d_port, files, shallow=False)
    assert not mismatch and not errors, mismatch
    assert len(files) == 1 + len(jx.jax.tree.leaves(jtree))

    (tp, to), step = CKPT.restore(str(ref_dir), (p, o))
    assert step == 5 and int(to.step) == 5
    for a, b in zip(jx.jax.tree.leaves(jtree), T.leaves((tp, to))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    (jp, jo), step = jx.CKPT.restore(str(port_dir), jtree)
    assert step == 5 and isinstance(jo, jx.A.AdamWState)
    for a, b in zip(T.leaves((p, o)), jx.jax.tree.leaves((jp, jo))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_corruption_is_caught_across_the_packages(jx, tmp_path):
    """A flipped byte in a leaf written by either package raises
    ``IOError`` in the other's restore."""
    tree = {"w": torch.arange(10.0), "b": torch.ones(3, dtype=torch.int32)}
    jtree = jx.jax.tree.map(lambda t: jx.jax.numpy.asarray(t.numpy()), tree)
    for save, restore, like, sub in (
            (CKPT.save, jx.CKPT.restore, jtree, "port"),
            (jx.CKPT.save, CKPT.restore, tree, "ref")):
        d = save(str(tmp_path / sub), 1, tree if sub == "port" else jtree)
        f = os.path.join(d, "arr_00001.npy")
        data = bytearray(open(f, "rb").read())
        data[-1] ^= 0xFF
        open(f, "wb").write(bytes(data))
        with pytest.raises(IOError):
            restore(str(tmp_path / sub), like)


def test_treedef_is_spelled_as_jax_spells_it(jx):
    """The manifest's structure string, for trees of dicts, tuples,
    lists, None and NamedTuples."""
    trees = [{"b": 1, "a": {"c": 2, "d": (3,)}}, [1, None, (2, 3)],
             (adamw.AdamWState(0, {"x": 1}, {"x": 2}),)]
    jtrees = [{"b": 1, "a": {"c": 2, "d": (3,)}}, [1, None, (2, 3)],
              (jx.A.AdamWState(0, {"x": 1}, {"x": 2}),)]
    for t, j in zip(trees, jtrees):
        assert T.treedef_str(t) == str(jx.jax.tree.flatten(j)[1])
        assert T.leaves(t) == jx.jax.tree.leaves(j)


def test_chip_smoke_training_phase_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 17 on the CPU, its main path at the
    smoke widths (the full config is for the card): every check of
    17a-e runs (17b holds the CPU against itself; 17e runs its gloo
    ranks over CPU tensors)."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # 17e's rank processes
    monkeypatch.setattr(cs, "get_config", smoke_config)
    monkeypatch.setattr(cs, "TRAIN", dict(n_layers=2, seq=64, batch=4,
                                          micro_steps=2, steps=2))
    monkeypatch.setattr(cs, "TRAIN_FAMILIES", ("qwen3-8b", "pixtral-12b"))
    monkeypatch.setattr(cs, "COMPRESS", dict(world=4, shapes=((64, 8),
                                                              (33,))))
    cs.phase_training(torch.device("cpu"), "cpu")
    out = capsys.readouterr().out
    assert out.count("[17a train] step") == 3
    assert "of the bf16 dense peak" in out
    assert out.count("[17b train card vs cpu]") == 2
    assert "[17c converge]" in out and "2 restores" in out
    assert "[17e compression] gloo, 4 rank(s) on cpu" in out

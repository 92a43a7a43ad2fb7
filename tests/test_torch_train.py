"""The port's training (``repro_torch.train``, the loss and the flash
backward) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; params and ``AdamWState`` are
drawn by the JAX package and carried across with ``convert``.  f32
tolerances: 1e-5 of each tensor's largest magnitude (the two frameworks
sum in other orders; measured up to 2.2e-6), and an Adam step's scale
for the updated params (``lm_parity.check_train_step``).  bf16 bounds
are twice the readings printed by ``pytest -s`` (on the CPU).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity  # noqa: E402
from lm_parity import one_thread  # noqa: E402,F401
from lm_parity import rel_err  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.models import flash  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train import adamw  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 1e-5


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    r = lm_parity.reference()
    from repro.models import flash as JF
    from repro.models import layers as JL
    from repro.train import adamw as JA
    from repro.train import train_step as JTS
    r.F, r.L, r.A, r.TS = JF, JL, JA, JTS
    return r


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ------------------------------------------------------------------ loss

LABEL_CASES = {"plain": (), "ignored": (-1,), "out-of-range": (-1, -5, 999)}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_cross_entropy_matches_reference(jx, rng, case):
    """Loss and its gradient in f32.  A label outside [0, V) scores 0 as
    the reference's one-hot row does (-1 is also ignored; -5 and 999 are
    counted, with the log-sum-exp alone as their nll)."""
    B, S, V = 2, 12, 40
    logits = rng.standard_normal((B, S, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    for i, bad in enumerate(LABEL_CASES[case]):
        labels[i % B, i::4] = bad
    jl, jg = jx.jax.value_and_grad(lambda x: jx.L.cross_entropy(
        x, jx.jnp.asarray(labels)))(jx.jnp.asarray(logits))
    x = _t(logits, True)
    loss = L.cross_entropy(x, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=F32)
    assert rel_err(jg, x.grad) <= F32


CE_CASES = [(64, 16, 0.0), (64, 16, 30.0), (16, 16, 0.0), (40, 16, 0.0)]


@pytest.mark.parametrize("S,chunk,softcap", CE_CASES,
                         ids=["chunked", "chunked-softcap",
                              "one-chunk", "not-a-multiple"])
def test_chunked_cross_entropy_matches_reference(jx, rng, monkeypatch, S,
                                                 chunk, softcap):
    """Both branches (S a multiple of and longer than ``chunk``: the loop
    with each chunk recomputed in the backward; else unchunked): loss and
    the gradients of the hidden and the unembed in f32; the loop runs
    each chunk twice (forward and recompute) and holds no (B, S, V)
    tensor."""
    B, d, V = 2, 24, 96
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[1, :5] = -1

    def jloss(x_, w_):
        return jx.L.chunked_cross_entropy(
            x_, w_, jx.jnp.asarray(labels), softcap=softcap, chunk=chunk)
    jl, (jgx, jgw) = jx.jax.value_and_grad(jloss, argnums=(0, 1))(
        jx.jnp.asarray(x), jx.jnp.asarray(w))
    calls, real = [], L._ce_chunk
    monkeypatch.setattr(L, "_ce_chunk", lambda *a: calls.append(
        a[0].shape) or real(*a))
    saved = []
    tx, tw = _t(x, True), _t(w, True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        loss = L.chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                       softcap=softcap, chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=F32)
    assert rel_err(jgx, tx.grad) <= F32 and rel_err(jgw, tw.grad) <= F32
    chunked = S % chunk == 0 and S > chunk
    assert len(calls) == (2 * S // chunk if chunked else 0)
    if chunked:
        assert all(np.prod(s) < B * S * V for s in saved), saved


def test_embedding_gradient_takes_the_reference_order(jx, rng):
    """The table's gradient under bf16 compute: the reference casts the
    table, then gathers, so repeated tokens' gradients meet in bf16; the
    port keeps that order when the table takes a gradient (equal to the
    reference here), and gathers then casts for serving (the same
    forward bits)."""
    V, d = 8, 16
    table = rng.standard_normal((V, d)).astype(np.float32)
    toks = rng.integers(0, 3, (4, 64)).astype(np.int32)   # many repeats
    up = rng.standard_normal((4, 64, d)).astype(np.float32)
    dt = jx.jnp.bfloat16

    def jf(t):
        return (t.astype(dt)[toks].astype(jx.jnp.float32) * up).sum()
    jg = np.asarray(jx.jax.grad(jf)(jx.jnp.asarray(table)))
    tt = _t(table, True)
    e = L.embed({"embed": tt}, torch.from_numpy(toks), torch.bfloat16)
    (e.float() * torch.from_numpy(up)).sum().backward()
    # gather then cast would sum the same contributions in f32
    f32_sum = np.zeros_like(table)
    np.add.at(f32_sum, toks.reshape(-1), np.asarray(
        jx.jnp.asarray(up.reshape(-1, d)).astype(dt).astype(jx.jnp.float32)))
    order = rel_err(jg, tt.grad)
    other = rel_err(jg, f32_sum)
    print(f"embed grad bf16: port {order:.3g}, gather-then-cast {other:.3g}")
    assert order <= 2 ** -7          # measured 0: one bf16 step at most
    with torch.no_grad():
        a = L.embed({"embed": tt}, torch.from_numpy(toks), torch.bfloat16)
    assert torch.equal(a, e.detach())


# ----------------------------------------------------------------- flash

FLASH_CASES = [  # (Sq, block_q, block_kv, window, softcap, causal, K)
    (256, 128, 128, 0, 0.0, True, 2),
    (256, 128, 256, 0, 0.0, True, 1),
    (384, 128, 128, 100, 0.0, True, 2),
    (256, 128, 128, 0, 20.0, True, 4),
    (256, 256, 128, 60, 15.0, False, 2),
]


@pytest.mark.parametrize("Sq,bq,bkv,window,softcap,causal,K", FLASH_CASES,
                         ids=["causal", "one-kv-block", "window",
                              "softcap-mha", "bidir-window-softcap"])
def test_flash_backward_matches_reference(jx, rng, Sq, bq, bkv, window,
                                          softcap, causal, K):
    """dq, dk, dv against ``jax.grad`` through the reference's
    ``flash_attention`` (its custom VJP) in f32, 4 query heads over K kv
    heads; the backward saves q, k, v, out, m, l only (no S x S tensor);
    the forward equals the no-grad (serving) forward bit for bit."""
    B, H, hd = 2, 4, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(window=window, causal=causal, softcap=softcap, block_q=bq,
              block_kv=bkv)

    def jf(q_, k_, v_):
        return (jx.F.flash_attention(q_, k_, v_, **kw)
                * jx.jnp.asarray(do)).sum()
    jg = jx.jax.grad(jf, argnums=(0, 1, 2))(*map(jx.jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        out = flash.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    for want, got in zip(jg, (tq.grad, tk.grad, tv.grad)):
        assert rel_err(want, got) <= F32
    assert len(saved) == 6
    assert max(np.prod(s) for s in saved) == B * Sq * H * hd
    with torch.no_grad():
        served = flash.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(served, out.detach())


# ----------------------------------------------------------------- adamw

def test_adamw_matches_reference_step_by_step(jx, rng):
    """Three updates of a small tree (clipping on; then a step with
    clipping off), the schedule across its warm-up edge, and
    ``clip_by_global_norm``: f32 within 1e-5 of each leaf."""
    tree = {"b": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "s": rng.standard_normal(5).astype(np.float32)},
            "a": rng.standard_normal((3, 4, 2)).astype(np.float32)}
    jp = jx.jax.tree.map(jx.jnp.asarray, tree)
    jst = jx.A.init(jp)
    p, st = convert.train_state_from_numpy(
        tree, jx.jax.tree.map(np.asarray, tuple(jst)), device="cpu")
    for i, clip in enumerate((1.0, 1.0, 0.0, 1.0)):
        g = jx.jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (
            3 if i % 2 else 0.1)).astype(np.float32), tree)
        jp, jst, jm = jx.A.update(jx.jax.tree.map(jx.jnp.asarray, g), jst,
                                  jp, clip=clip)
        p, st, m = adamw.update(T.tree_map(torch.from_numpy, g), st, p,
                                clip=clip)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=F32)
        for a, b in zip(jx.jax.tree.leaves((jp, tuple(jst))),
                        T.leaves((p, st))):
            assert rel_err(a, b) <= F32
    assert st.step.dtype == torch.int32 and int(st.step) == 4
    steps = np.array([0, 1, 98, 99, 100, 101, 5000, 9999, 10_000, 20_000],
                     np.int32)
    np.testing.assert_allclose(
        adamw.cosine_lr(torch.from_numpy(steps)).numpy(),
        np.asarray(jx.A.cosine_lr(jx.jnp.asarray(steps))), rtol=1e-6)
    g = jx.jax.tree.map(lambda a: a * 5, tree)
    jc, jn = jx.A.clip_by_global_norm(jx.jax.tree.map(jx.jnp.asarray, g))
    tc, tn = adamw.clip_by_global_norm(T.tree_map(torch.from_numpy, g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=F32)
    for a, b in zip(jx.jax.tree.leaves(jc), T.leaves(tc)):
        assert rel_err(a, b) <= F32


# ------------------------------------------------------------ train step

TRAIN_CASES = [(a, p, dt) for a, p in (("qwen3-8b", False),
                                        ("qwen3-moe-30b-a3b", False),
                                        ("pixtral-12b", True))
               for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,patches,dtype", TRAIN_CASES,
                         ids=[f"{dt}-{a}" + ("+patches" if p else "")
                              for a, p, dt in TRAIN_CASES])
def test_train_step_matches_reference(jx, arch, patches, dtype):
    """``make_train_step`` for the dense, moe and vlm smoke configs: loss,
    aux, every gradient leaf, then two steps (one with ``micro_steps =
    2``): metrics, params and ``AdamWState``; f32 at 1e-5, bf16 within
    ``lm_parity.BF16_TRAIN`` (readings printed with ``-s``)."""
    read = lm_parity.check_train_step(jx, arch, dtype, patches=patches,
                                      **lm_parity.train_tols(arch, dtype))
    print(f"{arch} {dtype} {read}")


def test_cast_params_once_matches_reference(jx, monkeypatch):
    """``REPRO_CAST_PARAMS_ONCE=1`` in both packages (read when the step
    is made), bf16: the same bounds as without it; in f32 the cast is the
    identity and the port's grads are the flag-off grads bit for bit."""
    monkeypatch.setenv("REPRO_CAST_PARAMS_ONCE", "1")
    read = lm_parity.check_train_step(
        jx, "qwen3-8b", "bfloat16", **lm_parity.BF16_TRAIN["qwen3-8b"])
    print(f"qwen3-8b bfloat16 cast-once {read}")
    cfg = R.smoke_config("qwen3-8b").replace(dtype="float32")
    _, tree = lm_parity.reference_params(jx, "qwen3-8b")
    batch = {k: torch.from_numpy(v) for k, v in
             lm_parity.train_batch(cfg, 1).items()}
    grads = []
    for once in (False, True):
        p, _ = convert.train_state_from_numpy(tree, device="cpu")
        for leaf in T.leaves(p):
            leaf.requires_grad_(True)
        TS.accumulate_grads(cfg, p, batch, cast_once=once)
        grads.append([leaf.grad for leaf in T.leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_moe_aux_is_differentiable(jx, rng):
    """The load-balance aux reaches the router and the routed input
    through the probabilities (the counts take no gradient), as the
    reference's ``jax.grad`` of its ``_route`` aux gives."""
    cfg = R.smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    xf = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32)
    jg = jx.jax.grad(lambda x, r: jx.MOE._route(cfg, x, r)[2],
                     argnums=(0, 1))(jx.jnp.asarray(xf),
                                     jx.jnp.asarray(router))
    tx, tr = _t(xf, True), _t(router, True)
    MOE._route(cfg, tx, tr)[2].backward()
    assert float(tr.grad.abs().max()) > 0
    assert rel_err(jg[0], tx.grad) <= F32 and rel_err(jg[1], tr.grad) <= F32


def test_input_specs_and_model_flops_match_reference(jx):
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs.base import SHAPES
    for arch in ("qwen3-8b", "qwen3-moe-30b-a3b", "pixtral-12b",
                 "whisper-tiny"):
        cfg, jcfg = R.get_config(arch), jx.R.get_config(arch)
        for name, shape in SHAPES.items():
            specs = M.input_specs(cfg, shape)
            jspecs = jx.M.input_specs(jcfg, JSHAPES[name])
            assert sorted(specs) == sorted(jspecs)
            for key, t in specs.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == jspecs[key].shape
                assert str(t.dtype).split(".")[1] == str(jspecs[key].dtype)
            assert M.model_flops(cfg, shape) == jx.M.model_flops(
                jcfg, JSHAPES[name])
    full = R.get_config("qwen3-8b").replace(n_layers=4)
    # the card's training cell: 6 N D at 4 layers, 8 x 4096 tokens
    assert M.model_flops(full, InputShape("t", 4096, 8, "train")) == (
        6.0 * full.param_count() * 8 * 4096)


# ------------------------------------------------------------------- fit

def test_loss_decreases():
    """The twin of ``tests/test_train.py::test_loss_decreases`` through
    the port's ``fit`` on the CPU (its own seeded init)."""
    from repro_torch.data.synthetic import token_stream
    from repro_torch.train.trainer import fit
    cfg = R.smoke_config("qwen3-8b")
    batch = next(token_stream(cfg.vocab_size, 4, 32, seed=0))
    rep = fit(cfg, InputShape("tiny", 32, 4, "train"),
              iter(lambda: batch, None), 30, log_every=0, device="cpu")
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)
    assert rep.final_step == 30 and len(rep.step_times) == 30


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.train.trainer import fit
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(R.smoke_config("qwen3-8b"), InputShape("t", 32, 4, "train"),
            iter([]), 1)


def test_cpu_train_step_loads_no_jax_and_no_reference():
    """A CPU train step, a checkpoint and the compression helpers import
    neither package."""
    code = (
        "import sys, tempfile, torch\n"
        "from repro_torch.configs.registry import smoke_config\n"
        "from repro_torch.configs.base import InputShape\n"
        "from repro_torch.data.synthetic import token_stream\n"
        "from repro_torch.distributed import compression as C\n"
        "from repro_torch.train import checkpoint as CK\n"
        "from repro_torch.train.trainer import fit\n"
        "cfg = smoke_config('qwen3-8b')\n"
        "rep = fit(cfg, InputShape('t', 32, 2, 'train'),\n"
        "          token_stream(cfg.vocab_size, 2, 32, seed=0), 2,\n"
        "          log_every=0, ckpt_dir=tempfile.mkdtemp(), device='cpu')\n"
        "C.quantize(torch.ones(3))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                     re.M)


def test_source_scan_covers_the_training_modules():
    """The training modules import neither package (``test_torch_engine``'s
    scan of every port source, with its pattern, walks them too)."""
    src = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(src, *p) for p in (
        ("tree.py",), ("train", "adamw.py"), ("train", "train_step.py"),
        ("train", "checkpoint.py"), ("train", "trainer.py"),
        ("distributed", "compression.py"))]
    for f in files:
        text = open(f).read()
        assert text and not _IMPORT.search(text), f
    assert _IMPORT.search("import jax.numpy as jnp\n")


# ------------------------------------------------------ on the card (gpu)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_backward_card_equals_cpu():
    """The flash forward and backward at the training path's blocks (S =
    1024, one 512 x 1024 tile pair), GQA and a window, f32, on the card
    against the CPU: within 1e-5 of each tensor's largest value (TF32
    off)."""
    dev = _cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.standard_normal((2, 1024, 8, 64)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 1024, 2, 64)).astype(
        np.float32)) for _ in range(2))
    outs = []
    for d in (dev, torch.device("cpu")):
        ins = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        out = flash.flash_attention(*ins, window=300)
        (out * do.to(d)).sum().backward()
        outs.append([out.detach().cpu()] + [t.grad.cpu() for t in ins])
    for a, b in zip(*outs):
        assert rel_err(b, a) <= F32


@pytest.mark.gpu
def test_train_step_card_equals_cpu():
    """Two steps of the dense smoke config in f32 (the second with
    ``micro_steps = 2``) on the card and on the CPU from the same
    weights: metrics within 1e-5, params within an Adam step's 1e-3."""
    dev = _cuda()
    from repro_torch.models.params import init_params
    cfg = R.smoke_config("qwen3-8b").replace(dtype="float32")
    host = init_params(M.param_defs(cfg), torch.Generator().manual_seed(0))
    sides = []
    for d in (dev, torch.device("cpu")):
        p = T.tree_map(lambda t: t.to(d, copy=True), host)
        sides.append([d, p, adamw.init(p)])
    shape = InputShape("t", lm_parity.TRAIN_S, lm_parity.TRAIN_B, "train")
    lrs = 0.0
    for n in (1, 2):
        step = TS.make_train_step(cfg, shape, micro_steps=n)
        b = lm_parity.train_batch(cfg, n)
        ms = []
        for side in sides:
            side[1], side[2], m = step(side[1], side[2], {
                k: torch.as_tensor(v, device=side[0]) for k, v in b.items()})
            ms.append({k: float(v) for k, v in m.items()})
        for k in ms[0]:
            np.testing.assert_allclose(ms[0][k], ms[1][k], rtol=F32)
        lrs += ms[1]["lr"]
    for a, b in zip(T.leaves(sides[0][1]), T.leaves(sides[1][1])):
        a = a.cpu().numpy()
        assert np.abs(a - b.numpy()).max() <= max(
            F32 * np.abs(a).max(), lm_parity.ADAM_STEP_TOL * lrs)

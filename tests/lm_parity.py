"""Shared by ``tests/test_torch_families.py``, ``tests/test_torch_ssm.py``
and the training tests (``tests/test_torch_train*.py``,
``check_train_step``): one family of the port against the JAX
package's, on the CPU.

Parameters are drawn once by the JAX package and carried across with
``convert.lm_params_from_numpy``; inputs are made with numpy from a
seed.  ``check_family`` compares the forward logits and the moe aux
loss, the prefill's last-token logits and every cache tensor, and four
greedy decode steps, with the tolerances of ``tests/test_torch_models.py``:
``F32_TOL`` in f32, ``BF16_TOL`` in bf16.

Expert routing (moe).  At every routing call the port's ``_route`` is
also fed the reference's own router input: on the same input it must
pick exactly the reference's experts, in both dtypes (so a router
product that lost f32 precision fails here).  In f32 the port's own
input gives the reference's choices too.  In bf16 the router's inputs
differ between the frameworks by a few bf16 steps, so where two
experts' probabilities nearly tie the two sides can pick differently;
one such token then differs in every later layer, far past any logit
tolerance.  So the bf16 cases assert that the port's own choice differs
from the reference's only at near-ties (the probabilities the port
gives the two choices within ``NEAR_TIE``) and at no more than
``MAX_FLIPS`` of the assignments, and then hold the outputs with the
reference's choices forced on the port's router.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.125, rtol=0.02)
# twice the largest readings of the bf16 cases of the suite (on the CPU):
# a routing difference at a probability gap of at most 0.00619 (qwen3-moe,
# S=1024), and at most 0.00595 of the assignments differing (llama4, S=40:
# 2 of 336; qwen3-moe at S=1024 80 of 16416, 0.00487)
NEAR_TIE = 0.0125
MAX_FLIPS = 0.012         # share of (token, slot) assignments


def reference():
    """The JAX package's modules that the checks call."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as JR
    from repro.models import model as JM
    from repro.models import moe as JMOE
    from repro.models.params import init_params

    class Ref:
        pass
    r = Ref()
    r.jax, r.jnp, r.R, r.M, r.MOE, r.init_params = (jax, jnp, JR, JM, JMOE,
                                                     init_params)
    r.params = {}        # arch -> (params, as numpy): one draw an arch
    return r


def reference_params(jx, arch: str):
    """The JAX package's params for ``arch``'s smoke config (seed 0) and
    their numpy tree, drawn once: they depend on neither the compute
    dtype nor the prompt."""
    if arch not in jx.params:
        jp = jx.init_params(jx.M.param_defs(jx.R.smoke_config(arch)),
                            jx.jax.random.key(0))
        jx.params[arch] = jp, jx.jax.tree.map(np.asarray, jp)
    return jx.params[arch]


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


class Routing:
    """The reference's expert choices, captured call by call (a
    ``jax.debug.callback`` in a wrapper of its ``_route``) with the
    router input they came from, and forced on the port's ``_route`` in
    the same order.  ``same_input`` counts the assignments where the
    port's ``_route`` on the reference's input picks another expert;
    ``flips`` records, for each of the port's calls, how many assignments
    its own choice changed and the largest probability gap between its
    choice and the reference's at those tokens."""

    def __init__(self, jx, monkeypatch):
        self.jx = jx
        self.ref, self.flips, self.n_assign, self.same_input = [], [], 0, 0
        real_j, real_t = jx.MOE._route, MOE._route

        def jroute(cfg, xf, router):
            top_p, top_i, aux = real_j(cfg, xf, router)
            jx.jax.debug.callback(
                lambda a, x: self.ref.append(
                    (np.asarray(a), np.array(x, np.float32))),
                top_i, xf, ordered=True)
            return top_p, top_i, aux

        def troute(cfg, xf, router):
            top_p, top_i, aux = real_t(cfg, xf, router)
            want, ref_x = self.ref.pop(0)
            want = torch.from_numpy(np.array(want)).to(top_i.dtype)
            self.n_assign += want.numel()
            _, same, _ = real_t(cfg, torch.from_numpy(ref_x).to(xf.dtype),
                                router)
            self.same_input += int((same != want).sum())
            bad = (top_i != want).any(1)
            if not bad.any():
                return top_p, top_i, aux
            probs = torch.softmax(xf.float() @ router.float(), -1)
            gap = (probs.gather(1, top_i) - probs.gather(1, want)).abs()
            self.flips.append((int((top_i != want).sum()),
                               float(gap[bad].max())))
            # the port's own probabilities at the reference's experts,
            # renormalised, and the aux loss of those choices
            p = probs.gather(1, want)
            p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
            E = cfg.n_experts
            counts = torch.bincount(want.reshape(-1), minlength=E).float()
            aux = E * torch.sum(counts / counts.sum() * probs.mean(0))
            return p, want, aux

        monkeypatch.setattr(jx.MOE, "_route", jroute)
        monkeypatch.setattr(MOE, "_route", troute)

    def sync(self):
        self.jx.jax.effects_barrier()

    def reading(self) -> str:
        n = sum(f for f, _ in self.flips)
        gap = max((g for _, g in self.flips), default=0.0)
        return (f"routing: {n} of {self.n_assign} assignments differ "
                f"({n / max(self.n_assign, 1):.5f}), largest gap {gap:.5f}")

    def check(self, dtype):
        assert not self.ref, "the port routed fewer times than the reference"
        assert self.same_input == 0, (
            f"{self.same_input} assignments differ on the reference's input")
        if dtype == "float32":
            assert not self.flips, f"f32 routing differs: {self.flips}"
            return
        n = sum(f for f, _ in self.flips)
        assert n <= MAX_FLIPS * self.n_assign, (n, self.n_assign)
        for _, gap in self.flips:
            assert gap <= NEAR_TIE, f"a routing difference at gap {gap}"


def _batch(cfg, toks, rng, patches: bool):
    """(jax batch, port batch) on the same numpy inputs."""
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (toks.shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if patches:
        extra["patches"] = rng.standard_normal(
            (toks.shape[0], cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: v for k, v in [("tokens", toks), *extra.items()]},
            {k: torch.from_numpy(v) for k, v in
             [("tokens", toks), *extra.items()]})


def check_family(jx, monkeypatch, arch: str, patches: bool, dtype: str,
                 S: int) -> "Routing | None":
    """One family at one dtype and prompt length S (2 sequences), the JAX
    package's ``jx`` (``reference()``) against the port; returns the moe
    family's ``Routing`` (its readings), else None."""
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.R.smoke_config(arch).replace(dtype=dtype)
    cfg = R.smoke_config(arch).replace(dtype=dtype)
    jp, tree = reference_params(jx, arch)
    p = convert.lm_params_from_numpy(cfg, tree,
                                     "cpu")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    routing = Routing(jx, monkeypatch) if cfg.family == "moe" else None
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    nb, tb = _batch(cfg, toks, rng, patches)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    S_all = S + (cfg.n_patches if patches else 0)

    jl, jaux = jax.jit(lambda p_, b: jx.M.forward(jcfg, p_, b,
                                                  remat=False))(jp, jb)
    routing and routing.sync()
    tl, aux = M.forward(cfg, p, tb)
    assert tl.dtype == torch.float32 and tl.shape == (2, S_all,
                                                      cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **tol)
    if cfg.family != "moe":
        assert float(aux) == 0.0

    L_ = S_all + 6
    jlo, jc = jax.jit(lambda p_, b: jx.M.prefill(jcfg, p_, b, L_))(jp, jb)
    routing and routing.sync()
    tlo, tc = M.prefill(cfg, p, tb, L_)
    assert tlo.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **tol)
    abstract = M.init_cache_abstract(cfg, 2, L_)
    jleaves = jax.tree.leaves(jc)
    assert len(tc) == len(jleaves) == len(abstract)
    for got, want, shape in zip(tc, jleaves, abstract):
        assert got.dtype == shape.dtype and got.shape == want.shape
        assert got.shape == shape.shape
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    dec = jax.jit(lambda p_, c, t, q: jx.M.decode_step(jcfg, p_, c, t, q))
    tok = np.asarray(jnp.argmax(jlo[:, -1], -1)).astype(np.int32)
    pos = np.full(2, S_all, np.int32)
    for _ in range(4):
        jlo, jc = dec(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        routing and routing.sync()
        tlo, tc2 = M.decode_step(cfg, p, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert all(a is b for a, b in zip(tc, tc2))     # written in place
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **tol)
        tok = np.asarray(jnp.argmax(jlo, -1)).astype(np.int32)
        pos = pos + 1
    for got, want in zip(tc, jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    if routing:
        routing.check(dtype)
    return routing


# ------------------------------------------------------------- training


@pytest.fixture(scope="module")
def one_thread():
    """One torch intra-op thread for a module of smoke-size steps: their
    ops are tiny, and under a parallel run (workers sharing the cores) a
    pool of threads a process spends most of its time waiting for the
    others (a phase-17 CPU run took 64 s against 11 s on a loaded host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TRAIN_B, TRAIN_S = 4, 32
# f32 training: each gradient leaf, m and sqrt(v) within this share of
# the leaf's largest magnitude (measured: 5.4e-6); an updated param also
# within ADAM_STEP_TOL of the learning rates applied (an Adam step moves
# a param by about lr whatever the gradient's size, so the leaves that
# start at 0 — the norm scales — are held at the step's scale; measured:
# 4.4e-9 absolute, 3e-4 of lr1 + lr2)
F32_TRAIN = 1e-5
ADAM_STEP_TOL = 1e-3
# bf16 compute over f32 masters: twice the readings of
# ``pytest -s tests/test_torch_train*.py -k bfloat16`` (on the CPU): the
# largest relative error of a metric (loss, aux, grad_norm, lr), of a
# gradient leaf and of an m or v leaf, and a param's largest difference
# in learning-rate steps (Adam moves an element by about lr whatever its
# gradient's size, so an element whose gradient is within bf16 noise of
# 0 can move the other way: at most ~2 steps over two steps)
BF16_TRAIN = {
    # readings: metric, grad, param steps, state (m and sqrt(v))
    "qwen3-8b": dict(metric_tol=0.0011, grad_tol=0.041, step_tol=3.4,
                     state_tol=0.044),   # 5.5e-4 0.0203 1.653 0.0219
    "qwen3-moe-30b-a3b": dict(metric_tol=0.0029, grad_tol=0.061,
                              step_tol=3.9, state_tol=0.23),
    # 1.45e-3 0.0301 1.929 0.111
    "pixtral-12b": dict(metric_tol=0.00088, grad_tol=0.032, step_tol=3.6,
                        state_tol=0.036),  # 4.4e-4 0.0156 1.799 0.0178
    "mamba2-370m": dict(metric_tol=0.0029, grad_tol=0.135, step_tol=3.9,
                        state_tol=0.094),  # 1.45e-3 0.0674 1.929 0.0468
    "zamba2-2.7b": dict(metric_tol=0.0026, grad_tol=0.068, step_tol=4.0,
                        state_tol=0.082),  # 1.29e-3 0.0337 1.990 0.0406
    "whisper-tiny": dict(metric_tol=0.00058, grad_tol=0.04, step_tol=3.8,
                         state_tol=0.035),  # 2.9e-4 0.0196 1.858 0.0172
}


def train_tols(arch: str, dtype: str) -> dict:
    return BF16_TRAIN[arch] if dtype == "bfloat16" else {}


def train_batch(cfg, seed: int, patches: bool = False) -> dict:
    """Seeded numpy inputs of a train step at (TRAIN_B, TRAIN_S): tokens,
    labels (three of them ``ignore_id``), frames or patches."""
    rng = np.random.default_rng(seed)
    shp = (TRAIN_B, TRAIN_S)
    b = {"tokens": rng.integers(0, cfg.vocab_size, shp).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, shp).astype(np.int32)}
    b["labels"][0, :3] = -1
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (TRAIN_B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if patches:
        b["patches"] = rng.standard_normal(
            (TRAIN_B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def rel_err(want, got) -> float:
    """max |want - got| over the largest |want| of the leaf."""
    want, got = _np(want), _np(got)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def check_train_step(jx, arch: str, dtype: str, *, patches: bool = False,
                     grad_tol: float = F32_TRAIN, state_tol: float = F32_TRAIN,
                     metric_tol: float = F32_TRAIN,
                     step_tol: float = ADAM_STEP_TOL) -> dict:
    """``arch``'s smoke config at ``dtype``, the JAX package's training
    against the port's on the same carried weights and numpy batches:
    (1) the loss, the aux and every gradient leaf of ``loss_fn``; (2) two
    steps of ``make_train_step`` (the second with ``micro_steps = 2``):
    loss, aux, grad_norm and lr each step, then every param and the
    ``AdamWState``.  Returns the largest relative errors (the readings
    behind the bf16 bounds)."""
    from repro.configs.base import InputShape as JShape
    from repro.train import adamw as JA
    from repro.train import train_step as JTS
    from repro_torch import tree as T
    from repro_torch.configs.base import InputShape
    from repro_torch.train import train_step as TS
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.R.smoke_config(arch).replace(dtype=dtype)
    cfg = R.smoke_config(arch).replace(dtype=dtype)
    jp, tree = reference_params(jx, arch)
    batches = [train_batch(cfg, s, patches) for s in (1, 2)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tbs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    read = {}

    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p_, b: JTS.loss_fn(jcfg, p_, b), has_aux=True))(jp, jbs[0])
    p, _ = convert.train_state_from_numpy(tree, device="cpu")
    for leaf in T.leaves(p):
        leaf.requires_grad_(True)
    m = TS.accumulate_grads(cfg, p, tbs[0])
    read["metric"] = 0.0

    def metrics_close(m, jm, keys):
        for k in keys:
            a, b = float(jm[k]), float(m[k])
            read["metric"] = max(read["metric"], abs(a - b) / max(abs(a), 1))
            np.testing.assert_allclose(b, a, rtol=metric_tol,
                                       atol=metric_tol)
    metrics_close(m, jm, ("loss", "aux"))
    grads = [rel_err(a, b.grad) for a, b in zip(jax.tree.leaves(jg),
                                                 T.leaves(p))]
    assert len(grads) == len(jax.tree.leaves(jg))
    read["grad"] = max(grads)
    assert read["grad"] <= grad_tol, grads

    shape = InputShape("t", TRAIN_S, TRAIN_B, "train")
    jshape = JShape("t", TRAIN_S, TRAIN_B, "train")
    js = [jax.jit(JTS.make_train_step(jcfg, jshape, micro_steps=n)[0])
          for n in (1, 2)]
    ts = [TS.make_train_step(cfg, shape, micro_steps=n) for n in (1, 2)]
    jstate = (jp, JA.init(jp))
    p, opt = convert.train_state_from_numpy(
        tree, jax.tree.map(np.asarray, tuple(jstate[1])), device="cpu")
    lrs = 0.0
    for jstep, tstep, jb, tb in zip(js, ts, jbs, tbs):
        *jstate, jm = jstep(*jstate, jb)
        p, opt, m = tstep(p, opt, tb)
        metrics_close(m, jm, ("loss", "aux", "grad_norm", "lr"))
        lrs += float(jm["lr"])
    assert int(opt.step) == int(jstate[1].step) == 2
    assert all(not leaf.requires_grad and leaf.grad is None
               for leaf in T.leaves(p))
    read["param_steps"] = 0.0
    for a, b in zip(jax.tree.leaves(jstate[0]), T.leaves(p)):
        a, b = _np(a), _np(b)
        read["param_steps"] = max(read["param_steps"],
                                  float(np.abs(a - b).max()) / lrs)
        np.testing.assert_allclose(b, a, rtol=0, atol=max(
            state_tol * np.abs(a).max(), step_tol * lrs))
    # v tracks g^2, so it is held as sqrt(v), which scales like g (a
    # relative error e in g is 2e in v)
    states = [rel_err(a, b) for a, b in zip(
        jax.tree.leaves(jstate[1].m), T.leaves(opt.m))] + [
        rel_err(np.sqrt(_np(a)), np.sqrt(_np(b))) for a, b in zip(
            jax.tree.leaves(jstate[1].v), T.leaves(opt.v))]
    read["state"] = max(states)
    assert read["state"] <= state_tol, states
    return read

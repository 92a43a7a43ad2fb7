"""The port's moe, vlm and encdec families against the JAX package's, on
the CPU: the whole model (``lm_parity.check_family``: forward, prefill
and four decode steps in f32 and bf16 at S=40, and for moe at S=1024
too; ``-s`` prints the bf16 routing readings) and the units
where the two frameworks could part: routing ties, capacity drops, the
sinusoid, the tanh GELU, and the decode route through
``decode_attention``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity  # noqa: E402
from lm_parity import F32_TOL, _np  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

CASES = [("qwen3-moe-30b-a3b", False), ("llama4-scout-17b-a16e", False),
         ("pixtral-12b", False), ("pixtral-12b", True),
         ("whisper-tiny", False)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    return lm_parity.reference()


MOE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
# S=40 in both dtypes for every case; S=1024 (capacity at a large token
# count, and the bf16 routing near-ties that only show there) for moe only
FAMILY_CASES = [(a, p, dt, S) for a, p in CASES for dt, S in (
    ("float32", 40), ("bfloat16", 40))] + [
    (a, False, dt, 1024) for a in MOE_ARCHS for dt in ("float32",
                                                         "bfloat16")]


@pytest.mark.parametrize(
    "arch,patches,dtype,S", FAMILY_CASES,
    ids=[f"{S}-{dt}-{a}" + ("+patches" if p else "")
         for a, p, dt, S in FAMILY_CASES])
def test_family_matches_reference(jx, monkeypatch, arch, patches, dtype, S):
    routing = lm_parity.check_family(jx, monkeypatch, arch, patches, dtype,
                                     S)
    if routing is not None:      # the readings behind lm_parity's limits
        print(f"{arch} {dtype} S={S} {routing.reading()}")


# ------------------------------------------------------------ moe units

def _moe_cfg(**kw):
    return R.smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32", **kw)


def test_route_breaks_ties_toward_the_lower_expert(jx, rng):
    """Equal router columns give equal probabilities: both sides take the
    lower expert first (``lax.top_k``), with equal gates and aux."""
    cfg = _moe_cfg(n_experts=8, moe_top_k=3)
    xf = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, 8)).astype(np.float32)
    router[:, [1, 4, 6]] = router[:, [2]]         # a three-way tie
    router[:5, 7] = 40.0                          # ... and a clear winner
    tp, ti, aux = MOE._route(cfg, torch.from_numpy(xf),
                             torch.from_numpy(router))
    jp, ji, jaux = jx.MOE._route(cfg, jx.jnp.asarray(xf),
                                 jx.jnp.asarray(router))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    tied = (ti.numpy()[:, :, None] == np.array([1, 2, 4, 6])).any(-1)
    assert tied.any()
    for row in ti.numpy():   # tied experts in ascending order within a row
        t = [e for e in row if e in (1, 2, 4, 6)]
        assert t == sorted(t)


def test_route_product_is_f32_on_bf16_inputs(jx, rng):
    """bf16 hidden states are routed by the f32 product ``xf.float() @
    router.float()``, as the reference's: the gates equal those of that
    product's softmax to the bit, and not those of a bf16 product; the
    reference's ``_route`` on the same bf16 input picks the same experts."""
    cfg = R.smoke_config(MOE_ARCHS[0]).replace(dtype="bfloat16")
    T, d, E, k = 512, cfg.d_model, cfg.n_experts, cfg.moe_top_k
    x32 = rng.standard_normal((T, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32) * 0.2
    xf = torch.from_numpy(x32).to(torch.bfloat16)
    top_p, top_i, _ = MOE._route(cfg, xf, torch.from_numpy(router))

    def gates(logits):
        p, i = torch.sort(torch.softmax(logits.float(), -1), dim=-1,
                          descending=True, stable=True)
        p = p[:, :k]
        return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9), i[:, :k]

    want_p, want_i = gates(xf.float() @ torch.from_numpy(router))
    assert torch.equal(top_i, want_i) and torch.equal(top_p, want_p)
    bf_p, _ = gates(xf @ torch.from_numpy(router).to(torch.bfloat16))
    assert not torch.equal(top_p, bf_p)
    jp, ji, _ = jx.MOE._route(cfg, jx.jnp.asarray(xf.float().numpy()).astype(
        jx.jnp.bfloat16), jx.jnp.asarray(router))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp), **F32_TOL)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_dense_drops_at_capacity_as_the_reference(jx, rng,
                                                      capacity_factor):
    """A router skewed toward expert 0 overflows its capacity: the same
    assignments are dropped (in order of arrival) and the outputs match."""
    cfg = _moe_cfg(n_experts=4, moe_top_k=2, capacity_factor=capacity_factor)
    p = {name: rng.standard_normal(d.shape).astype(np.float32) * 0.2
         for name, d in MOE.moe_param_defs(cfg, (), ()).items()}
    p["router"][:, 0] += 0.5
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32) + 0.5
    y, aux = MOE._moe_dense(cfg, {k: torch.from_numpy(v) for k, v in
                                  p.items()}, torch.from_numpy(x))
    jy, jaux = jx.MOE._moe_dense(cfg, {k: jx.jnp.asarray(v) for k, v in
                                       p.items()}, jx.jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    T = 48
    C = MOE._capacity(cfg, T)
    assert C == jx.MOE._capacity(cfg, T)
    _, ti, _ = MOE._route(cfg, torch.from_numpy(x.reshape(T, -1)),
                          torch.from_numpy(p["router"]))
    counts = np.bincount(ti.numpy().reshape(-1), minlength=4)
    assert np.maximum(counts - C, 0).sum() > 0      # some were dropped
    fe = ti.reshape(-1)
    rank = MOE._ranks(fe, 4).numpy()
    seen = np.zeros(4, int)
    for e, r in zip(fe.numpy(), rank):              # order of arrival
        assert r == seen[e]
        seen[e] += 1


def test_capacity_matches_reference(jx):
    for arch in MOE_ARCHS:
        cfg = R.get_config(arch)
        for n in (1, 8, 64, 8192, 12345):
            assert MOE._capacity(cfg, n) == jx.MOE._capacity(cfg, n)


# ------------------------------------------------------------ encdec units

def test_sinusoid_and_gelu_match_reference(jx, rng):
    jnp = jx.jnp
    from repro.models import encdec as JED
    from repro.models import layers as JL
    # the frequencies agree to 2 f32 ulps (XLA's and torch's exp round
    # differently); at position p that moves an angle by at most p times
    # 2 ulps of a frequency <= 1, which bounds the embeddings' difference
    ulp2 = 2.0 ** -22
    for d in (64, 384, 7):
        one = np.ones(1, np.int32)
        half = d // 2
        freqs = ED._sinusoid(torch.from_numpy(one), d).numpy()[0]
        jfreqs = np.asarray(JED._sinusoid(jnp.asarray(one), d))[0]
        np.testing.assert_allclose(np.arcsin(freqs[:half]),
                                   np.arcsin(jfreqs[:half]), rtol=ulp2,
                                   atol=0)
        for top in (447, 1499):       # whisper's decoder cap, enc_seq
            pos = np.array([0, 1, 17, top], np.int32)
            np.testing.assert_allclose(
                ED._sinusoid(torch.from_numpy(pos), d).numpy(),
                np.asarray(JED._sinusoid(jnp.asarray(pos), d)),
                atol=max(top * ulp2, F32_TOL["atol"]), rtol=0)
    h = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    w1 = rng.standard_normal((16, 40)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((40, 16)).astype(np.float32) * 0.3
    got = L.gelu_mlp(*map(torch.from_numpy, (h, w1, w2)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.gelu_mlp(*map(jnp.asarray, (h, w1, w2)))),
        **F32_TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(h @ w1)) @ \
        torch.from_numpy(w2)
    assert not torch.allclose(got, exact, atol=1e-6)   # the tanh form


def test_encdec_prefill_needs_frames_as_the_reference(jx):
    cfg = R.smoke_config("whisper-tiny")
    params = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(KeyError, match="frames"):
        M.prefill(cfg, params, {"tokens": toks}, 8)
    jcfg = jx.R.smoke_config("whisper-tiny")
    jp = jx.init_params(jx.M.param_defs(jcfg), jx.jax.random.key(0))
    with pytest.raises(KeyError, match="frames"):
        jx.M.prefill(jcfg, jp, {"tokens": jx.jnp.zeros((2, 5), "int32")}, 8)


# ------------------------------------------------------------ decode route

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
                                  "pixtral-12b", "whisper-tiny"])
def test_decode_self_attention_goes_through_the_kernel(monkeypatch, rng,
                                                       arch):
    """Every decoder layer's self-attention at decode calls
    ``decode_attention`` once with pos + 1; with that call swapped for
    ``attend_decode`` at pos the step gives the same logits (f32)."""
    cfg = R.smoke_config(arch).replace(dtype="float32")
    params = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(1))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (3, 30)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3)).int()
    pos = torch.full((3,), 30, dtype=torch.int32)
    calls, real = [], DA.decode_attention

    def counted(q, k, v, n):
        calls.append(int(n[0]))
        return real(q, k, v, n)

    out = []
    for fn in (counted, lambda q, k, v, n: L.attend_decode(q, k, v, n - 1)):
        monkeypatch.setattr(DA, "decode_attention", fn)
        _, cache = M.prefill(cfg, params, batch, 36)
        out.append(M.decode_step(cfg, params, cache, tok, pos)[0])
    assert calls == [31] * cfg.n_layers
    np.testing.assert_allclose(_np(out[0]), _np(out[1]), **F32_TOL)

"""The port's LM substrate (``repro_torch.models``) against the JAX
package's, on the CPU.

Parameters are drawn once by the JAX package (``init_params`` from a
seed) and carried across with ``convert.lm_params_from_numpy``; inputs
are made with numpy from a seed.  Tolerances:

* f32 (``dtype="float32"``): atol 1e-4, rtol 1e-4 — the two sides sum
  in another order (logits here are of magnitude ~5; measured
  differences are ~1e-5).
* bf16 (the configs' default): atol 0.125, rtol 0.02 on logits and
  caches — four bf16 steps at magnitude 4-8, where one step is 2^-5;
  the two frameworks round bf16 products and activations at different
  places (measured differences up to 0.08).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.models import flash, layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.125, rtol=0.02)
ARCHS = ["qwen3-8b", "phi3-mini-3.8b"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model modules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as JR
    from repro.models import flash as JF
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.models.params import count_params, init_params

    class Ref:
        pass
    r = Ref()
    r.jax, r.jnp, r.R, r.F, r.L, r.M = jax, jnp, JR, JF, JL, JM
    r.init_params, r.count_params = init_params, count_params
    return r


def _models(jx, arch, dtype, seed=0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jx.R.smoke_config(arch).replace(dtype=dtype)
    cfg = R.smoke_config(arch).replace(dtype=dtype)
    jp = jx.init_params(jx.M.param_defs(jcfg), jx.jax.random.key(seed))
    tree = jx.jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, convert.lm_params_from_numpy(cfg, tree, "cpu")


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ------------------------------------------------------------ layers

def test_norms_rope_and_mlp_match_reference(jx, rng):
    jnp = jx.jnp
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32) * 0.1
    for fn in ("rms_norm", "l2_head_norm"):
        np.testing.assert_allclose(
            _np(getattr(L, fn)(torch.from_numpy(x), torch.from_numpy(s))),
            _np(getattr(jx.L, fn)(jnp.asarray(x), jnp.asarray(s))),
            **F32_TOL)
    pos = np.array([[0, 3, 9, 100, 7]], np.int32)
    for theta in (10_000.0, 1e6, 0.0):
        np.testing.assert_allclose(
            _np(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)),
            _np(jx.L.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            **F32_TOL)
    h = rng.standard_normal((3, 8)).astype(np.float32)
    w = [rng.standard_normal(sh).astype(np.float32)
         for sh in ((8, 12), (8, 12), (12, 8))]
    np.testing.assert_allclose(
        _np(L.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w))),
        _np(jx.L.swiglu(jnp.asarray(h), *map(jnp.asarray, w))), **F32_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 50.0),
                                            (7, 30.0)])
def test_attention_matches_reference(jx, rng, window, softcap):
    jnp = jx.jnp
    B, S, K, G, hd = 2, 24, 2, 3, 16
    q = rng.standard_normal((B, S, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kw = dict(window=window, softcap=softcap)
    np.testing.assert_allclose(
        _np(L.attend_full(*map(torch.from_numpy, (q, k, v)), **kw)),
        _np(jx.L.attend_full(*map(jnp.asarray, (q, k, v)), **kw)),
        **F32_TOL)
    pos = np.array([3, 23], np.int32)
    np.testing.assert_allclose(
        _np(L.attend_decode(*map(torch.from_numpy, (q[:, 0], k, v, pos)),
                            **kw)),
        _np(jx.L.attend_decode(*map(jnp.asarray, (q[:, 0], k, v, pos)),
                               **kw)), **F32_TOL)
    cache = torch.zeros((B, S, K, hd))
    L.scatter_kv(cache, torch.from_numpy(k[:, 0]), torch.from_numpy(pos))
    want = jx.L.scatter_kv(jnp.zeros((B, S, K, hd)), jnp.asarray(k[:, 0]),
                           jnp.asarray(pos))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,window,softcap", [(1024, 0, 0.0),
                                              (1024, 300, 0.0),
                                              (2048, 0, 20.0)])
def test_flash_forward_matches_reference(jx, rng, S, window, softcap):
    """The blocked forward at and past the 1024 threshold, and the
    dispatch that picks it."""
    jnp = jx.jnp
    B, K, G, hd = 1, 2, 2, 8
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (K * G, K, K))
    assert flash.flash_ok(S, S) == jx.F.flash_ok(S, S)
    assert flash._pick_block(S, 512) == jx.F._pick_block(S, 512)
    kw = dict(window=window, softcap=softcap)
    got = flash.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jx.F.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    via = L.attend(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    full = L.attend_full(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)
    out, m, l = flash._fwd_impl(*map(torch.from_numpy, (q, k, v)), window,
                                True, softcap, 512, 1024)
    jo, jm, jl = jx.F._fwd_impl(*map(jnp.asarray, (q, k, v)),
                                jnp.asarray(window, jnp.float32), True,
                                softcap, 512, 1024)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **F32_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("S", [40, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(jx, arch, dtype, S):
    """forward, prefill (logits and caches) and four decode steps, S under
    and at the flash threshold."""
    jnp = jx.jnp
    jcfg, jp, cfg, p = _models(jx, arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, _ = jx.M.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         remat=False)
    tl, aux = M.forward(cfg, p, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)

    L_ = S + 6
    jlo, jc = jx.M.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, L_)
    tlo, tc = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks)}, L_)
    assert tlo.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **tol)
    for got, want in zip(tc, jc):
        assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        assert not got[:, :, S:].any()

    tok = np.asarray(jnp.argmax(jlo[:, -1], -1)).astype(np.int32)
    pos = np.full(2, S, np.int32)
    for _ in range(4):
        jlo, jc = jx.M.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                   jnp.asarray(pos))
        tlo, tc2 = M.decode_step(cfg, p, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert tc2[0] is tc[0] and tc2[1] is tc[1]     # written in place
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **tol)
        tok = np.asarray(jnp.argmax(jlo, -1)).astype(np.int32)
        pos = pos + 1
    for got, want in zip(tc, jc):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_route_equals_attend_decode(monkeypatch, arch, dtype):
    """Each decode layer of these models goes through ``decode_attention``
    (with pos + 1); with that call swapped for ``attend_decode`` (with
    pos), the step gives the same logits and caches within the stated
    tolerance."""
    cfg = R.smoke_config(arch).replace(dtype=dtype)
    params = P.init_params(M.param_defs(cfg),
                           torch.Generator().manual_seed(1),
                           cast=lambda n, t: t.to(M.stored_dtype(cfg, n)))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 30)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3)).int()
    pos = torch.full((3,), 30, dtype=torch.int32)
    calls = []
    real = DA.decode_attention

    def counted(q, k, v, p):
        calls.append(1)
        return real(q, k, v, p)

    def plain(q, k, v, p):
        return L.attend_decode(q, k, v, p - 1)

    out = {}
    for name, fn in (("kernel route", counted), ("attend_decode", plain)):
        monkeypatch.setattr(T.DA, "decode_attention", fn)
        _, cache = M.prefill(cfg, params, {"tokens": toks}, 36)
        logits, cache = M.decode_step(cfg, params, cache, tok, pos)
        out[name] = (logits, cache)
    assert len(calls) == cfg.n_layers
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    (la, ca), (lb, cb) = out.values()
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **tol)
    for x, y in zip(ca, cb):
        np.testing.assert_allclose(_np(x), _np(y), **tol)


def test_windowed_and_softcapped_layers_decode_plain(jx, monkeypatch):
    """gemma2 (sliding windows, score softcap): no layer goes through the
    kernel, as no layer of the reference does; the step equals the
    reference's in f32."""
    jnp = jx.jnp
    jcfg, jp, cfg, p = _models(jx, "gemma2-27b", "float32")
    assert cfg.attn_softcap and list(T.layer_windows(cfg)) == list(
        jx.M.family_module(jcfg).layer_windows(jcfg))
    monkeypatch.setattr(T.DA, "decode_attention", None)   # never called
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 50)).astype(np.int32)
    jlo, jc = jx.M.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 56)
    tlo, tc = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks)}, 56)
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **F32_TOL)
    tok = np.array([3, 9], np.int32)
    pos = np.full(2, 50, np.int32)
    jlo, _ = jx.M.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                              jnp.asarray(pos))
    tlo, _ = M.decode_step(cfg, p, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **F32_TOL)


# ------------------------------------------------------------ params

@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_param_defs_and_counts_match_reference(jx, arch):
    for cfg_fn in ("get_config", "smoke_config"):
        jcfg = getattr(jx.R, cfg_fn)(arch)
        cfg = getattr(R, cfg_fn)(arch)
        jdefs, defs = jx.M.param_defs(jcfg), M.param_defs(cfg)
        flat = {path: d for path, d in P._leaves(defs)}
        jflat = {tuple(k.key for k in path): d for path, d in
                 jx.jax.tree_util.tree_flatten_with_path(
                     jdefs, is_leaf=lambda x: hasattr(x, "logical"))[0]}
        assert list(flat) == list(jflat)
        for key, d in flat.items():
            j = jflat[key]
            assert (d.shape, d.logical, d.init, d.scale) == (
                tuple(j.shape), j.logical, j.init, j.scale)
        assert P.count_params(defs) == jx.count_params(jdefs)
    jc = jx.M.init_cache_abstract(jcfg, 3, 40)
    tc = M.init_cache_abstract(cfg, 3, 40)
    assert len(tc) == len(jc)
    for got, want in zip(tc, jc):
        assert got.device.type == "meta"
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)


def test_init_params_draws_the_reference_std_in_stored_dtypes():
    cfg = R.smoke_config("qwen3-8b").replace(d_model=256, d_ff=512,
                                             vocab_size=2048)
    gen = torch.Generator().manual_seed(0)
    p = P.init_params(M.param_defs(cfg), gen,
                      cast=lambda n, t: t.to(M.stored_dtype(cfg, n)))
    again = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(0),
                          cast=lambda n, t: t.to(M.stored_dtype(cfg, n)))
    assert torch.equal(p["blocks"]["wq"], again["blocks"]["wq"])
    assert p["embed"].dtype == torch.float32
    assert p["blocks"]["attn_norm"].dtype == torch.float32
    assert not p["blocks"]["attn_norm"].any()
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        assert p["blocks"][name].dtype == torch.bfloat16
    assert p["unembed"].dtype == torch.bfloat16
    # std = scale / sqrt(fan_in), fan_in = shape[-2]
    assert abs(float(p["embed"].std()) - 1.0 / np.sqrt(2048)) < 2e-3
    assert abs(float(p["blocks"]["wd"].float().std())
               - 1.0 / np.sqrt(512)) < 2e-3


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """A leaf past ``SLICE_ELEMS`` is drawn one axis-0 slice at a time, each
    cast to its stored dtype at once: same std, the stored dtype, the same
    values from the same seed."""
    monkeypatch.setattr(P, "SLICE_ELEMS", 3 * 64 * 128)
    cfg = R.smoke_config("qwen3-moe-30b-a3b").replace(n_layers=8,
                                                      n_experts=16)
    casts = []

    def cast(name, t):
        casts.append((name, tuple(t.shape), t.dtype))
        return t.to(M.stored_dtype(cfg, name))

    p = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(0),
                      cast=cast)
    again = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(0),
                          cast=lambda n, t: t.to(M.stored_dtype(cfg, n)))
    we = p["blocks"]["we_g"]                     # (8, 16, 64, 64)
    assert we.dtype == torch.bfloat16 and we.shape == (8, 16, 64, 64)
    assert [c for c in casts if c[0] == "we_g"] == [
        ("we_g", (1, 16, 64, 64), torch.float32)] * 8
    assert torch.equal(we, again["blocks"]["we_g"])
    assert abs(float(we.float().std()) - 1.0 / np.sqrt(64)) < 2e-3
    assert not torch.equal(we[0], we[1])
    assert p["blocks"]["router"].dtype == torch.float32
    assert p["embed"].dtype == torch.float32   # 256 x 64: one draw
    assert [c for c in casts if c[0] == "embed"] == [
        ("embed", (256, 64), torch.float32)]

"""The port's ssm (mamba2) and hybrid (zamba2) families against the JAX
package's, on the CPU: the whole model (``lm_parity.check_family``) and
the SSD units: the chunked scan against its own step-by-step recurrence,
the causal conv's carried state, ``_segsum``, and the hybrid's shared
block through ``decode_attention``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity  # noqa: E402
from lm_parity import F32_TOL, _np  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.models import hybrid as HY  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    return lm_parity.reference()


# S=1024 (SSD chunking past 256) in f32; S=40 in both dtypes
@pytest.mark.parametrize("dtype,S", [("float32", 40), ("bfloat16", 40),
                                     ("float32", 1024)])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_family_matches_reference(jx, monkeypatch, arch, dtype, S):
    lm_parity.check_family(jx, monkeypatch, arch, False, dtype, S)


def _ssd_inputs(rng, B=2, S=48, nh=3, hp=4, N=5):
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, nh, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, nh, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [48, 16, 8])
def test_ssd_chunked_equals_the_step_recurrence(jx, rng, chunk):
    """The chunked scan (1, 3 and 6 chunks) equals ``ssd_decode`` run one
    token at a time from a zero state, and the reference's scan."""
    x, dt, A, Bm, Cm = _ssd_inputs(rng)
    t = list(map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    y, state = MB.ssd_chunked(*t, chunk=chunk)
    st = torch.zeros((2, 3, 4, 5))
    steps = []
    for s in range(x.shape[1]):
        ys, st = MB.ssd_decode(t[0][:, s], t[1][:, s], t[2], t[3][:, s],
                               t[4][:, s], st)
        steps.append(ys)
    np.testing.assert_allclose(y.numpy(), torch.stack(steps, 1).numpy(),
                               **F32_TOL)
    np.testing.assert_allclose(state.numpy(), st.numpy(), **F32_TOL)
    from repro.models import mamba2 as JMB
    jy, jst = JMB.ssd_chunked(*map(jx.jnp.asarray, (x, dt, A, Bm, Cm)),
                              chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jst), **F32_TOL)
    with pytest.raises(AssertionError):          # S % min(chunk, S) != 0
        MB.ssd_chunked(*t, chunk=36)


def test_segsum_and_conv_state_match_reference(jx, rng):
    from repro.models import mamba2 as JMB
    jnp = jx.jnp
    cs = np.cumsum(rng.standard_normal((2, 3, 6)), -1).astype(np.float32)
    got = MB._segsum(torch.from_numpy(cs)).numpy()
    want = np.asarray(JMB._segsum(jnp.asarray(cs)))
    assert np.isneginf(got[..., 0, 1]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **F32_TOL)
    # the conv over a whole sequence == over a prefix, then the rest with
    # the carried (B, C, W-1) state, one token at a time
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y, st = MB.causal_depthwise_conv(xt, wt)
    jy, jst = JMB.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert st.shape == (2, 6, 3)
    y0, state = MB.causal_depthwise_conv(xt[:, :5], wt)
    parts = [y0]
    for s in range(5, 11):
        ys, state = MB.causal_depthwise_conv(xt[:, s:s + 1], wt, state)
        parts.append(ys)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y.numpy(),
                               **F32_TOL)
    np.testing.assert_array_equal(state.numpy(), st.numpy())


def test_ssm_cache_is_o1_and_f32_state(jx):
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        cfg = R.get_config(arch)
        a, b = (M.init_cache_abstract(cfg, 3, n) for n in (16, 4096))
        assert [t.shape for t in a[:3]] == [t.shape for t in b[:3]]
        assert a[2].dtype == torch.float32 and a[0].dtype == torch.bfloat16
        j = jx.M.init_cache_abstract(jx.R.get_config(arch), 3, 4096)
        assert [tuple(t.shape) for t in b] == [t.shape for t in j]


def test_hybrid_shared_block_decodes_through_the_kernel(monkeypatch, rng):
    """The shared block's decode attention calls ``decode_attention`` once
    a use (window 0, pos + 1), with the same weights each time; with the
    plain ``attend_decode`` at pos the step gives the same logits."""
    cfg = R.smoke_config("zamba2-2.7b").replace(dtype="float32")
    params = P.init_params(M.param_defs(cfg), torch.Generator().manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 32)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3)).int()
    pos = torch.full((3,), 32, dtype=torch.int32)
    calls, real = [], DA.decode_attention

    def counted(q, k, v, n):
        calls.append(int(n[0]))
        return real(q, k, v, n)

    out = []
    for fn in (counted, lambda q, k, v, n: L.attend_decode(q, k, v, n - 1)):
        monkeypatch.setattr(DA, "decode_attention", fn)
        _, cache = M.prefill(cfg, params, {"tokens": toks}, 40)
        out.append(M.decode_step(cfg, params, cache, tok, pos))
    assert calls == [33] * HY.n_uses(cfg)
    np.testing.assert_allclose(_np(out[0][0]), _np(out[1][0]), **F32_TOL)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_chip_smoke_family_phases_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 15 on the CPU at the smoke widths (the
    full configs are for the card): every check of 15a-c runs, the first
    decode_attention call of each captured family is recorded for phase
    4, and the gather calls of the serve calls are logged."""
    import os
    import re
    import sys

    from repro_torch.configs.registry import smoke_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    monkeypatch.setattr(cs, "get_config", smoke_config)
    monkeypatch.setattr(cs, "fit_depth", lambda cfg, dev: (cfg.n_layers, 0))
    cpu = torch.device("cpu")
    ds, meta, store, _ = cs.phase_index(1500, 32, 12)
    pools = cs.PathLog(cpu)
    caps = {a: cs.FirstCall(DA, "decode_attention") for a in (
        cs.MOE_ARCH, "llama4-scout-17b-a16e", "zamba2-2.7b",
        cs.WHISPER["arch"])}
    geom = dict(cs.RAG_GEOM, doc_len=24, prompt_len=8, max_new_tokens=3)
    cs.phase_moe_serve(ds, meta, store, cpu, log_=pools,
                       capture=caps[cs.MOE_ARCH], doorbell=16, **geom)
    cs.phase_families_serve(ds, meta, store, cpu, log_=pools, captures=caps,
                            doorbell=16, **geom)
    cs.phase_card_vs_cpu(cpu, **cs.CARD_CPU)
    out = capsys.readouterr().out
    assert "[15a moe] 2 calls generated equal tokens" in out
    assert "expert assignments dropped at capacity" in out
    # 15a's layer 0, rebuilt from the engine's parameters, routes as the
    # serve call did: the host's recount equals the call's
    m = re.search(r"\[15a moe layer 0\].*recomputed on the host: "
                  r"([0-9.]+) \(counted in the call ([0-9.]+)\)", out)
    assert m and m.group(1) == m.group(2), out[-3000:]
    assert out.count("[15c card vs cpu]") == len(cs.CARD_CPU_ARCHS)
    assert "[15b vlm] pixtral-12b model-level prefill with 4 patches" in out
    for arch, cap in caps.items():
        q, k, v, pos = cap.args
        w = cs.WHISPER
        assert k.shape[1] == (w["prompt_len"] + w["max_new_tokens"]
                              if arch == w["arch"] else 4 * 24 + 8 + 3)
    assert pools.calls and all(n == 0 for n in pools.launches.values())

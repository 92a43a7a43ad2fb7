"""The port's ``decode_attention`` against the JAX package's, and against
its plain torch version on the card.

On the CPU the port's wrapper runs its plain torch version; it is held
against the reference's Pallas kernel, run the way
``tests/test_kernels.py`` runs it (interpret mode on the CPU backend),
and against the reference's oracle ``decode_attention_ref``.  Inputs are
made with numpy from a seed and cross the frameworks as numpy.
Tolerances: f32 atol 2e-5 / rtol 1e-4 (the sums run in another order),
bf16 atol = rtol = 0.02 (the reference's own bf16 test), both as in
``tests/test_kernels.py``.

The partial mode (a cache sharded by sequence over ranks) is held on the
CPU through its merge (``layers.merge_parts``) against the unsharded
plain version, shards with no valid key included.

Tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card (f32 as above; bf16 within ``BF16_STEPS`` of the largest
output, since both round one f32 result to bf16); they decide inside
the test whether a card exists and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.models import layers as L  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=0.02, rtol=0.02)
BF16_STEPS = 2.0 ** -6
# test_kernels.py's sweep: (B, S, K, G, hd)
SWEEP = [(1, 256, 1, 1, 64), (3, 512, 4, 2, 64), (2, 1024, 2, 8, 128),
         (5, 300, 6, 1, 32)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's entry points (imported here, so the ``gpu`` tests
    also run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.decode_attention.ops import decode_attention
    from repro.kernels.decode_attention.ref import decode_attention_ref as jr
    from repro.models import layers as JL

    class Ref:
        pass
    r = Ref()
    r.jnp, r.ops, r.oracle, r.layers = jnp, decode_attention, jr, JL
    return r


def _inputs(rng, B, S, K, G, hd, pos=None):
    q = rng.standard_normal((B, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    if pos is None:
        pos = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(pos, np.int32)


def _torch(*arrays, dtype=torch.float32):
    *fl, pos = arrays
    return [torch.from_numpy(a).to(dtype) for a in fl] + [
        torch.from_numpy(pos)]


def _bf16_np(a):
    """The bf16 value of each element, as f32 numpy."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("B,S,K,G,hd", SWEEP)
def test_decode_attention_sweep_matches_reference(ref, rng, B, S, K, G, hd):
    q, k, v, pos = _inputs(rng, B, S, K, G, hd)
    jnp = ref.jnp
    jargs = [jnp.asarray(a) for a in (q, k, v, pos)]
    oj = np.asarray(ref.ops(*jargs))            # Pallas, interpret mode
    orf = np.asarray(ref.oracle(*jargs))
    out = DA.decode_attention(*_torch(q, k, v, pos))
    assert out.dtype == torch.float32 and out.shape == (B, K * G, hd)
    np.testing.assert_allclose(out.numpy(), orf, **F32_TOL)
    np.testing.assert_allclose(out.numpy(), oj, **F32_TOL)
    plain = decode_attention_ref(*_torch(q, k, v, pos))
    np.testing.assert_allclose(plain.numpy(), orf, **F32_TOL)


@pytest.mark.parametrize("B,S,K,G,hd", SWEEP)
def test_decode_attention_bf16_matches_reference(ref, rng, B, S, K, G, hd):
    q, k, v, pos = _inputs(rng, B, S, K, G, hd)
    jnp = ref.jnp
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jargs.append(jnp.asarray(pos))
    oj = np.asarray(ref.ops(*jargs), np.float32)
    orf = np.asarray(ref.oracle(*jargs), np.float32)
    out = DA.decode_attention(*_torch(q, k, v, pos, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16      # q's dtype, as the reference
    np.testing.assert_allclose(out.float().numpy(), oj, **BF16_TOL)
    np.testing.assert_allclose(out.float().numpy(), orf, **BF16_TOL)
    raw = decode_attention_ref(*_torch(q, k, v, pos, dtype=torch.bfloat16))
    assert raw.dtype == torch.float32       # the oracle's raw f32
    np.testing.assert_allclose(raw.numpy(), orf, **F32_TOL)


def test_decode_attention_pos_zero_behaviours(ref, rng):
    """pos = 0: the reference's Pallas kernel skips every block and returns
    zeros; its oracle (and the port's plain version) return the mean of v.
    pos = 1: only the first entry is attended, on both sides."""
    q, k, v, _ = _inputs(rng, 2, 256, 1, 2, 32)
    pos = np.array([0, 1], np.int32)
    jnp = ref.jnp
    jargs = [jnp.asarray(a) for a in (q, k, v, pos)]
    oj = np.asarray(ref.ops(*jargs))
    orf = np.asarray(ref.oracle(*jargs))
    np.testing.assert_array_equal(oj[0], 0.0)
    np.testing.assert_allclose(orf[0], np.broadcast_to(v[0, :, 0].mean(0),
                                                       (2, 32)), atol=1e-5)
    out = DA.decode_attention(*_torch(q, k, v, pos)).numpy()
    np.testing.assert_allclose(out[0], orf[0], **F32_TOL)
    for o in (oj, orf, out):
        np.testing.assert_allclose(o[1], np.broadcast_to(v[1, 0, 0], (2, 32)),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_route_equals_attend_decode(ref, rng, dtype):
    """The decode path's call, ``decode_attention(q, kc, vc, pos + 1)``,
    against ``attend_decode(q, kc, vc, pos)`` (which attends to kpos <=
    pos), in the port and in the reference."""
    B, S, K, G, hd = 3, 80, 2, 4, 16
    q, k, v, _ = _inputs(rng, B, S, K, G, hd)
    pos = np.array([0, 41, 79], np.int32)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tp = _torch(q, k, v, pos, dtype=tdt)
    route = DA.decode_attention(tq, tk, tv, tp + 1).float().numpy()
    plain = L.attend_decode(tq, tk, tv, tp).float().numpy()
    jnp = ref.jnp
    jdt = getattr(jnp, dtype)
    jplain = np.asarray(ref.layers.attend_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos)), np.float32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(route, plain, **tol)
    np.testing.assert_allclose(route, jplain, **tol)
    np.testing.assert_allclose(plain, jplain, **tol)


@pytest.mark.parametrize("B,K,S", [(8, 8, 1056), (16, 8, 32768), (1, 1, 1),
                                   (64, 8, 64), (2, 2, 300), (1000, 8, 10)])
def test_decode_attention_splits_cover_the_cache(B, K, S):
    n, split_len = DA.splits(B, K, S)
    assert split_len % 64 == 0 and split_len >= 64
    assert n * split_len >= S > (n - 1) * split_len
    assert B * K * n <= max(DA._TARGET_WARPS, B * K)


@pytest.mark.parametrize("B,K,S", [(8, 8, 1056), (16, 8, 32768), (1, 1, 1),
                                   (64, 8, 64), (2, 2, 300), (1000, 8, 10)])
def test_decode_attention_warps_per_head_fill_the_card(B, K, S):
    """Pairs x warps per head x splits stay within the warps the card holds
    at once (or one warp per pair when the pairs alone exceed it), and
    the warps per head are a power of two up to a CTA's width."""
    wph = DA.warps_per_head(B, K)
    n, _ = DA.splits(B, K, S)
    assert wph & (wph - 1) == 0 and 1 <= wph <= DA.WARPS
    assert B * K * wph * n <= max(DA._TARGET_WARPS, B * K)
    if B * K * 2 <= DA._TARGET_WARPS:
        assert B * K * wph * 2 > DA._TARGET_WARPS or wph == DA.WARPS


def test_decode_attention_phase4_shapes_cut_as_measured():
    """The cuts ``python3 chip_smoke.py --sweep`` measured fastest on the
    H100 at ``chip_smoke.py``'s two decode shapes: 8 warps on each kv
    head, the path's 1056-entry caches in 2 splits and the 32K caches in
    one."""
    assert (DA.warps_per_head(8, 8), DA.splits(8, 8, 1056)) == (8, (2, 576))
    assert (DA.warps_per_head(16, 8),
            DA.splits(16, 8, 32768)) == (8, (1, 32768))


def test_decode_attention_checks_inputs_and_launches_nothing_on_cpu(rng):
    q, k, v, pos = _torch(*_inputs(rng, 2, 64, 2, 2, 16))
    with pytest.raises(ValueError):
        DA.decode_attention(q[:, :3], k, v, pos)          # H % K
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, v[:, :10], pos)
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, v, pos[:1])
    DA.launches = 0
    DA.decode_attention(q, k, v, pos)
    assert DA.launches == 0


def test_decode_attention_traces_its_impl(rng):
    from repro_torch.obs.trace import TRACER
    q, k, v, pos = _torch(*_inputs(rng, 2, 64, 2, 2, 16))
    TRACER.configure()
    try:
        DA.decode_attention(q, k, v, pos)
        spans = [s for s in TRACER.snapshot()
                 if s["name"] == "kernel.decode_attention"]
    finally:
        TRACER.disable()
    assert len(spans) == 1 and spans[0]["attrs"]["impl"] == "ref"


# ------------------------------------------------------ on the card (gpu)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,pos", [
    *[(B, S, K, G, hd, None) for B, S, K, G, hd in SWEEP],
    (8, 1056, 8, 4, 128, [1025] * 8),      # qwen3-8b's first decode step
    (4, 700, 8, 4, 128, [1, 64, 65, 700]),  # ragged pos, tile edges
    (4, 700, 8, 4, 128, [127, 128, 129, 385]),  # around split edges
    (3, 333, 32, 1, 96, [333, 100, 7]),     # phi3-mini: hd 96, G 1
    (8, 1056, 4, 8, 128, [1025] * 8),      # qwen3-moe: G 8
    (8, 1056, 8, 5, 128, [1025, 3, 700, 1056, 64, 65, 1, 2]),  # llama4: G 5
    (8, 1056, 32, 1, 80, [1025] * 8),      # zamba2's shared block: hd 80
    (8, 96, 6, 1, 64, [65, 96, 1, 30, 64, 63, 2, 9]),  # whisper: hd 64
    (2, 130, 2, 16, 256, [130, 129]),
    (2, 64, 1, 3, 8, [64, 33])])
def test_decode_attention_kernel_on_card(B, S, K, G, hd, pos, dtype):
    dev = _cuda()
    rng = np.random.default_rng(B * 131 + S)
    q, k, v, p = _torch(*_inputs(rng, B, S, K, G, hd, pos),
                        dtype=getattr(torch, dtype))
    q, k, v, p = (t.to(dev) for t in (q, k, v, p))
    before = DA.launches
    out = DA.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    want = decode_attention_ref(q, k, v, p).to(q.dtype).float().cpu().numpy()
    tol = F32_TOL if dtype == "float32" else dict(
        atol=BF16_STEPS * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(out.float().cpu().numpy(), want, **tol)
    # every reduction runs in a fixed order: a second launch is bit-equal
    assert torch.equal(DA.decode_attention(q, k, v, p), out)


@pytest.mark.gpu
def test_decode_attention_kernel_pos_zero_on_card():
    """The kernel follows the Pallas kernel at pos = 0 (zeros), where the
    plain version follows the oracle (the mean of v)."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    q, k, v, p = (t.to(dev) for t in _torch(*_inputs(rng, 2, 256, 2, 2, 64,
                                                       [0, 256])))
    out = DA.decode_attention(q, k, v, p).cpu()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    want = decode_attention_ref(q, k, v, p).cpu()
    np.testing.assert_allclose(out[1].numpy(), want[1].numpy(), **F32_TOL)


@pytest.mark.gpu
def test_decode_attention_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    rng = np.random.default_rng(6)
    q, k, v, p = (t.to(dev) for t in _torch(*_inputs(rng, 2, 64, 2, 2, 20)))
    with pytest.raises(ValueError, match="multiple of 8"):
        DA.decode_attention(q, k, v, p)
    q, k, v, p = (t.to(dev) for t in _torch(*_inputs(rng, 2, 64, 2, 2, 16)))
    with pytest.raises(ValueError, match="f32"):
        DA.decode_attention(q, k.bfloat16(), v.bfloat16(), p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split,warps,wph", [(1, 8, 8), (1, 1, 1),
                                               (2, 4, 2), (5, 8, 1),
                                               (17, 2, 2), (3, 8, 4)])
def test_decode_attention_kernel_split_edges_on_card(n_split, warps, wph,
                                                     dtype):
    """The one-launch combine at a given cut of the cache and CTA shape
    (warps, and warps sharing a kv head): pos just before, at and just
    after split boundaries (so the last live split is short,
    whole, or a single key, and later splits are never read), two
    back-to-back launches bit-equal, and every arrival counter back at 0
    after each launch."""
    dev = _cuda()
    B, S, K, G, hd = 6, 1088, 4, 4, 128
    tiles = -(-S // 64)
    split_len = -(-tiles // n_split) * 64
    n_split = -(-S // split_len)
    edges = [split_len - 1, split_len, split_len + 1, min(S, 2 * split_len),
             1, S]
    rng = np.random.default_rng(n_split * 10 + warps)
    q, k, v, p = (t.to(dev) for t in _torch(
        *_inputs(rng, B, S, K, G, hd, [min(e, S) for e in edges]),
        dtype=getattr(torch, dtype)))
    want = decode_attention_ref(q, k, v, p).to(q.dtype).float().cpu().numpy()
    tol = F32_TOL if dtype == "float32" else dict(
        atol=BF16_STEPS * np.abs(want).max(), rtol=0)
    outs = []
    for _ in range(2):
        bufs = DA.buffers(q, k, n_split, split_len)
        DA._launch(q, k, v, p, *bufs, warps, wph)
        torch.cuda.synchronize()
        assert not DA.arrivals(q.device, B * K).any()
        outs.append(bufs[2])
    np.testing.assert_allclose(outs[0].float().cpu().numpy(), want, **tol)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_decode_attention_kernel_back_to_back_on_one_stream():
    """Twenty launches queued without a sync between them (as phase 4 of
    ``chip_smoke.py`` times them) each combine their own splits: every
    output equals the first, and the counters end at 0."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    q, k, v, p = (t.to(dev) for t in _torch(
        *_inputs(rng, 8, 1056, 8, 4, 128, [1025] * 8), dtype=torch.bfloat16))
    outs = [DA.decode_attention(q, k, v, p) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert not DA.arrivals(q.device, 64).any()


def _shards(k, v, counts, n):
    """The n sequence shards of k, v and each one's count of valid
    entries (``counts`` over the whole cache)."""
    S_l = k.shape[1] // n
    return [(k[:, r * S_l:(r + 1) * S_l], v[:, r * S_l:(r + 1) * S_l],
             (counts - r * S_l).clamp(0, S_l)) for r in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_partial_mode_merges_to_the_whole(rng, n):
    """The plain partial mode on each of n sequence shards, merged by the
    parts' log-sum-exp, equals the unsharded plain version within 1e-6
    in f32; rows whose valid keys all lie in the first shard leave the
    later shards with none (l = 0: a zero row and lse -inf, weight 0)."""
    q, k, v, p = _torch(*_inputs(rng, 4, 48, 2, 4, 32, [5, 48, 20, 1]))
    parts = [decode_attention_ref(q, ks, vs, c, partial=True)
             for ks, vs, c in _shards(k, v, p, n)]
    empty = [c for _, _, c in _shards(k, v, p, n)][-1] == 0
    assert empty.any()
    for (o, lse), (_, _, c) in zip(parts, _shards(k, v, p, n)):
        assert torch.equal(o[c == 0], torch.zeros_like(o[c == 0]))
        assert torch.isneginf(lse[c == 0]).all()
    got = L.merge_parts(torch.stack([o for o, _ in parts]),
                        torch.stack([lse for _, lse in parts]))
    want = decode_attention_ref(q, k, v, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # the wrapper's partial mode on CPU tensors is the plain one
    o, lse = DA.decode_attention(q, *_shards(k, v, p, n)[0], partial=True)
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, parts[0][0]) and torch.equal(lse, parts[0][1])


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (20, 0.0), (0, 30.0),
                                            (20, 30.0)])
def test_attend_decode_part_merges_to_attend_decode(rng, window, softcap):
    """``attend_decode_part`` over 4 sequence shards (positions offset by
    each shard's start), merged, equals ``attend_decode`` over the whole
    cache within 1e-6 in f32, with a window and a score softcap (the
    route of gemma2's layers) and a shard past every position."""
    q, k, v, _ = _torch(*_inputs(rng, 3, 64, 2, 2, 16))
    pos = torch.tensor([3, 63, 40], dtype=torch.int32)
    parts = [L.attend_decode_part(q, k[:, r * 16:(r + 1) * 16],
                                  v[:, r * 16:(r + 1) * 16], pos, r * 16,
                                  window=window, softcap=softcap)
             for r in range(4)]
    assert torch.isneginf(parts[3][1][0]).all()
    got = L.merge_parts(torch.stack([o for o, _ in parts]),
                        torch.stack([lse for _, lse in parts]))
    want = L.attend_decode(q, k, v, pos, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_partial_on_card(dtype):
    """The kernel's partial mode against the plain one at a sequence
    shard's shape (qwen3-moe's K=4, G=8 on a shard of 8 ranks), an empty
    shard's rows included: out within the module's tolerance (f32 rows
    both ways, so bf16 inputs only differ in the sum's order), lse
    within 1e-5, -inf where the shard has no key."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    q, k, v, p = (t.to(dev) for t in _torch(
        *_inputs(rng, 8, 512, 4, 8, 128, [0, 512, 1, 300, 0, 64, 65, 511]),
        dtype=getattr(torch, dtype)))
    before, before_partial = DA.launches, DA.partial_launches
    o, lse = DA.decode_attention(q, k, v, p, partial=True)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    assert DA.partial_launches == before_partial + 1
    wo, wl = decode_attention_ref(q, k, v, p, partial=True)
    np.testing.assert_allclose(o.cpu().numpy(), wo.cpu().numpy(), **F32_TOL)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(wl))
    fin = torch.isfinite(wl)
    np.testing.assert_allclose(lse[fin].cpu().numpy(), wl[fin].cpu().numpy(),
                               atol=1e-5, rtol=1e-6)
    assert torch.equal(o[p == 0], torch.zeros_like(o[p == 0]))

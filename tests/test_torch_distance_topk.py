"""The port's ``distance_topk`` against the JAX package's, and against its
plain torch version on the card.

On the CPU the port's wrapper runs its plain torch version; both are held
against the reference's oracle ``distance_topk_ref`` and against its
Pallas kernel run the way ``tests/test_kernels.py`` runs it (interpret
mode).  Inputs are made with numpy from a seed and cross the frameworks
as numpy.  Tolerances: distances within rtol 1e-5 (the two sides sum in
a different order); ids equal except where the reference's distances tie
within 1e-5 relative.

Tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card; they decide inside the test whether a card exists and skip
here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.distance_topk import ops as DO  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.quant_topk.ref import ids_agree_up_to_ties  # noqa: E402

RTOL = 1e-5
SWEEP = [(1, 100, 16, 1), (7, 333, 128, 10), (37, 1000, 960, 5),
         (128, 256, 64, 16), (130, 513, 32, 3)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's ``distance_topk`` entry points (imported here, so
    the ``gpu`` tests also run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.distance_topk.ops import distance_topk
    from repro.kernels.distance_topk.ref import distance_topk_ref as jref

    class Ref:
        pass
    r = Ref()
    r.jnp, r.ops, r.oracle = jnp, distance_topk, jref
    return r


def _inputs(rng, B, N, D):
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def _ext(d, i, k):
    """A plain top list extended with inf/-1 to k + 1 columns, -1 at every
    inf: the reference list the tie rule reads."""
    d, i = np.asarray(d, np.float64), np.asarray(i)
    pad = k + 1 - d.shape[1]
    if pad > 0:
        d = np.concatenate([d, np.full((len(d), pad), np.inf)], 1)
        i = np.concatenate([i, np.full((len(i), pad), -1)], 1)
    return d, np.where(np.isfinite(d), i, -1)


def _jax_oracle_ext(ref, q, x, k, n_valid=None):
    jnp = ref.jnp
    kk = min(k + 1, x.shape[0])
    d, i = ref.oracle(jnp.asarray(q), jnp.asarray(x), kk,
                      x.shape[0] if n_valid is None else n_valid)
    return _ext(d, i, k)


def _assert_topk(d, i, d_ext, i_ext, atol=0.0):
    k = i.shape[1]
    ok, n = ids_agree_up_to_ties(i, i_ext, d_ext, rtol=RTOL)
    assert ok, f"{n} ids differ beyond ties"
    live = np.isfinite(d_ext[:, :k])
    assert (np.isfinite(d) == live).all()
    np.testing.assert_allclose(d[live], d_ext[:, :k][live], rtol=RTOL,
                               atol=atol)
    assert (i[~live] == -1).all()


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("B,N,D,k", SWEEP)
def test_distance_topk_sweep_matches_reference(ref, rng, B, N, D, k):
    q, x = _inputs(rng, B, N, D)
    d_ext, i_ext = _jax_oracle_ext(ref, q, x, k)
    dj, ij = ref.ops(ref.jnp.asarray(q), ref.jnp.asarray(x), k,
                     interpret=True)
    # the reference's Pallas kernel agrees with its own oracle
    _assert_topk(np.asarray(dj), np.asarray(ij), d_ext, i_ext, atol=1e-3)
    pd, pi = DO.distance_topk(torch.from_numpy(q), torch.from_numpy(x), k)
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    assert pd.shape == pi.shape == (B, k)
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    # and the port's result against the Pallas kernel's own list
    _assert_topk(pd.numpy(), pi.numpy(), *_ext(
        np.concatenate([np.asarray(dj), d_ext[:, k:]], 1),
        np.concatenate([np.asarray(ij), i_ext[:, k:]], 1), k), atol=1e-3)
    rd, ri = distance_topk_ref(torch.from_numpy(q), torch.from_numpy(x), k)
    _assert_topk(rd.numpy(), ri.numpy(), d_ext, i_ext)


@pytest.mark.parametrize("n_valid", [1, 50, 255, 256])
def test_distance_topk_masking_matches_reference(ref, rng, n_valid):
    q, x = _inputs(rng, 5, 256, 32)
    dj, ij = ref.ops(ref.jnp.asarray(q), ref.jnp.asarray(x), 8,
                     n_valid=n_valid, interpret=True)
    pd, pi = DO.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 8,
                              n_valid=n_valid)
    d_ext, i_ext = _jax_oracle_ext(ref, q, x, 8, n_valid)
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    live = pi.numpy() >= 0
    assert (pi.numpy()[live] < n_valid).all()
    np.testing.assert_array_equal(live, np.asarray(ij) >= 0)
    np.testing.assert_array_equal(pi.numpy()[live], np.asarray(ij)[live])
    if n_valid < 8:          # padding semantics: inf/-1 tail
        assert np.isinf(pd.numpy()[:, n_valid:]).all()
        assert (pi.numpy()[:, n_valid:] == -1).all()


def test_distance_topk_bf16_inputs_match_reference(ref, rng):
    """bf16 inputs are cast to f32 before the search, as the reference
    wrapper casts them: both sides then search the same f32 values."""
    jnp = ref.jnp
    qb = jnp.asarray(rng.standard_normal((9, 64)), jnp.bfloat16)
    xb = jnp.asarray(rng.standard_normal((300, 64)), jnp.bfloat16)
    q = np.array(qb.astype(jnp.float32))
    x = np.array(xb.astype(jnp.float32))
    d_ext, i_ext = _jax_oracle_ext(ref, q, x, 5)
    pd, pi = DO.distance_topk(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(x).bfloat16(), 5)
    assert pd.dtype == torch.float32
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    dj, ij = ref.ops(qb, xb, 5, interpret=True)
    np.testing.assert_allclose(pd.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=1e-3)


@pytest.mark.parametrize("n_valid", [3, None])
def test_distance_topk_k_past_valid_rows(ref, rng, n_valid):
    """k larger than the valid rows: the tail is inf/-1, as the reference
    wrapper returns it (its Pallas kernel pads N to a whole tile)."""
    q, x = _inputs(rng, 4, 6, 16)
    nv = 6 if n_valid is None else n_valid
    dj, ij = ref.ops(ref.jnp.asarray(q), ref.jnp.asarray(x), 8,
                     n_valid=n_valid, interpret=True)
    pd, pi = DO.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 8,
                              n_valid=n_valid)
    assert pd.shape == (4, 8)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pd.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=1e-4)
    assert np.isinf(pd.numpy()[:, nv:]).all() and (pi[:, nv:] == -1).all()
    assert sorted(pi[0, :nv].tolist()) == list(range(nv))


@pytest.mark.parametrize("B,N,D,k", SWEEP[:3])
def test_distance_topk_use_ref_is_the_plain_version(ref, rng, B, N, D, k):
    """``use_ref=True`` returns the plain version's raw result, as the
    reference wrapper does."""
    q, x = _inputs(rng, B, N, D)
    dj, ij = ref.ops(ref.jnp.asarray(q), ref.jnp.asarray(x), k, use_ref=True)
    pd, pi = DO.distance_topk(torch.from_numpy(q), torch.from_numpy(x), k,
                              use_ref=True)
    _assert_topk(pd.numpy(), pi.numpy(), *_jax_oracle_ext(ref, q, x, k))
    np.testing.assert_allclose(pd.numpy(), np.asarray(dj), rtol=RTOL)


def test_distance_topk_checks_inputs_and_launches_nothing_on_cpu(rng):
    q, x = (torch.from_numpy(a) for a in _inputs(rng, 3, 20, 8))
    with pytest.raises(ValueError):
        DO.distance_topk(q, x[:, :4], 2)
    with pytest.raises(ValueError):
        DO.distance_topk(q, x, 0)
    with pytest.raises(ValueError):
        DO.distance_topk(q, x.to(torch.int32), 2)
    DO.launches = 0
    DO.distance_topk(q, x, 4)
    assert DO.launches == 0


def test_distance_topk_traces_its_impl(rng):
    from repro_torch.obs.trace import TRACER
    q, x = (torch.from_numpy(a) for a in _inputs(rng, 3, 20, 8))
    TRACER.configure()
    try:
        DO.distance_topk(q, x, 4)
        spans = [s for s in TRACER.snapshot()
                 if s["name"] == "kernel.distance_topk"]
    finally:
        TRACER.disable()
    assert len(spans) == 1 and spans[0]["attrs"]["impl"] == "ref"


# ------------------------------------------------------ on the card (gpu)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,D,k,n_valid", [
    *[(B, N, D, k, None) for B, N, D, k in SWEEP],
    (5, 256, 32, 8, 1), (5, 256, 32, 8, 50), (4, 6, 16, 8, 3),
    (128, 4096, 128, 10, None), (70, 3000, 128, 128, 2900),
    (2000, 20000, 128, 20, 19000)])
def test_distance_topk_kernel_on_card(B, N, D, k, n_valid):
    dev = _cuda()
    rng = np.random.default_rng(B * 7 + N)
    q, x = (torch.from_numpy(a).to(dev) for a in _inputs(rng, B, N, D))
    before = DO.launches
    d, i = DO.distance_topk(q, x, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert DO.launches == before + 1
    nv = N if n_valid is None else n_valid
    dr, ir = distance_topk_ref(q, x, min(k + 1, N), nv)
    _assert_topk(d.cpu().numpy(), i.cpu().numpy(),
                 *_ext(dr.cpu().numpy(), ir.cpu().numpy(), k), atol=1e-3)


@pytest.mark.gpu
def test_distance_topk_kernel_bf16_on_card():
    """bf16 inputs: the kernel equals the plain version on the same
    f32-cast inputs."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    q, x = (torch.from_numpy(a).to(dev).bfloat16()
            for a in _inputs(rng, 300, 5000, 64))
    d, i = DO.distance_topk(q, x, 10)
    dr, ir = distance_topk_ref(q.float(), x.float(), 11)
    _assert_topk(d.cpu().numpy(), i.cpu().numpy(),
                 *_ext(dr.cpu().numpy(), ir.cpu().numpy(), 10), atol=1e-3)

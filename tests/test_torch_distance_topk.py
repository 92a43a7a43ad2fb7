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
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
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


def _twin_rows(x):
    """Make the second half of the rows copies of the first half, and row 1
    a copy of row 0: equal distances across tiles, chunks and inside one
    tile.  Returns the id each row copies (its own id for the originals)."""
    half = len(x) // 2
    x[1] = x[0]
    x[half:2 * half] = x[:half]
    twin = np.arange(len(x))
    twin[1] = 0
    twin[half:2 * half] = twin[:half]
    return twin


def _assert_ties_to_lower_id(d, i, twin):
    """The lists are ascending by (distance, id), and a copied row never
    comes before (or without) the row it copies."""
    for b in range(len(d)):
        live = i[b] >= 0
        db, ib = d[b][live], i[b][live]
        assert (np.diff(db) >= 0).all()
        same = db[1:] == db[:-1]
        assert (ib[1:][same] > ib[:-1][same]).all()
        pos = {int(v): p for p, v in enumerate(ib)}
        for v, p in pos.items():
            if twin[v] != v:
                assert pos.get(int(twin[v]), len(ib)) < p, (b, v, twin[v])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,D,k,n_valid,twins,tile,S", [
    *[(B, N, D, k, None, False, None, None) for B, N, D, k in SWEEP],
    (5, 256, 32, 8, 1, False, None, None),
    (5, 256, 32, 8, 50, False, None, None),
    (4, 6, 16, 8, 3, False, None, None),
    (128, 4096, 128, 10, None, False, None, None),
    (70, 3000, 128, 128, 2900, False, None, None),
    (2000, 20000, 128, 20, 19000, False, None, None),
    # equal distances across tiles, chunks and inside a tile
    (128, 4096, 128, 10, None, True, None, None),
    (129, 5000, 64, 16, 4999, True, 128, 3),
    (129, 5000, 64, 16, 4999, True, 64, 7),
    # k = K_MAX with n_valid inside a tile; B not a multiple of either tile
    (130, 1000, 64, 128, 777, False, None, None),
    (65, 3000, 32, 128, 2001, True, 64, 4),
    # D = 960; rows of 120 and 132 bytes (8- and 4-byte copies)
    (37, 2000, 960, 10, None, True, None, None),
    (200, 3000, 960, 10, 2999, False, 128, 2),
    (77, 3000, 30, 10, None, True, None, None),
    (77, 3000, 30, 10, None, False, 128, 3),
    (77, 3000, 33, 10, 2900, True, 64, 5),
    (133, 1500, 33, 128, None, False, 64, 2)])
def test_distance_topk_kernel_on_card(B, N, D, k, n_valid, twins, tile, S):
    dev = _cuda()
    rng = np.random.default_rng(B * 7 + N)
    q, x = _inputs(rng, B, N, D)
    twin = _twin_rows(x) if twins else None
    q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    nv = N if n_valid is None else n_valid
    if tile is None:
        before = DO.launches
        d, i = DO.distance_topk(q, x, k, n_valid=n_valid)
        torch.cuda.synchronize()
        assert DO.launches == before + 1
    else:
        bufs = QO.buffers(B, k, S, dev)
        DO._launch(q, x, k, nv, bufs, tile, S)
        torch.cuda.synchronize()
        d, i = bufs[2], bufs[3]
    dr, ir = distance_topk_ref(q, x, min(k + 1, N), nv)
    _assert_topk(d.cpu().numpy(), i.cpu().numpy(),
                 *_ext(dr.cpu().numpy(), ir.cpu().numpy(), k), atol=1e-3)
    if twins:
        _assert_ties_to_lower_id(d.cpu().numpy(), i.cpu().numpy(), twin)


@pytest.mark.gpu
def test_distance_topk_kernel_queued_launches_on_card():
    """Twenty launches queued on one stream with no sync between them, at
    the wrappers' cut and at the 128 x 128 tile, each give what one launch
    of theirs gave: the chunk merge's arrival counters are left at 0 by
    every launch.  The rows start one float into
    their buffer, so the copies narrow to 4 bytes."""
    dev = _cuda()
    rng = np.random.default_rng(6)
    q, x = (torch.from_numpy(a).to(dev) for a in _inputs(rng, 300, 20001,
                                                         128))
    x = x.flatten()[1:1 + 20000 * 128].view(20000, 128)
    assert QO.copy_width(4 * 128, q, x) == 4
    assert QO.launch_shape(300, 20000, 10, False)[1] > 1
    one = DO.distance_topk(q, x, 10)
    b1 = QO.buffers(300, 10, 3, dev)
    DO._launch(q, x, 10, 20000, b1, 128, 3)
    torch.cuda.synchronize()
    before = DO.launches
    outs = [DO.distance_topk(q, x, 10) for _ in range(20)]
    bufs = [QO.buffers(300, 10, 3, dev) for _ in range(20)]
    for b in bufs:
        DO._launch(q, x, 10, 20000, b, 128, 3)
    torch.cuda.synchronize()
    assert DO.launches == before + 20
    want = distance_topk_ref(q, x, 11, 20000)
    for d, i in (one, (b1[2], b1[3])):
        _assert_topk(d.cpu().numpy(), i.cpu().numpy(),
                     *_ext(want[0].cpu().numpy(), want[1].cpu().numpy(), 10),
                     atol=1e-3)
    for d, i in outs:
        assert torch.equal(d, one[0]) and torch.equal(i, one[1])
    for b in bufs:
        assert torch.equal(b[2], b1[2]) and torch.equal(b[3], b1[3])
    assert not QO.arrivals(dev, 1).any()


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

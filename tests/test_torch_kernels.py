"""The port's kernels against the JAX package's, and against their plain
torch versions on the card.

On the CPU the port's wrappers run their plain torch versions; they are
held against the reference's ``ops`` functions run the way
``tests/test_kernels.py`` runs them (Pallas in interpret mode).  Inputs
are made with numpy from a seed and cross the frameworks as numpy.

Tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card; they decide inside the test whether a card exists and skip
here.  Tolerances: distances within rtol 1e-5 (the two sides sum in a
different order), ids equal except where the reference's distances tie
within 1e-5 relative; gathers are exact copies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gather_blocks import ops as GO  # noqa: E402
from repro_torch.kernels.gather_blocks.ref import gather_blocks_ref  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
from repro_torch.kernels.quant_topk.ref import (  # noqa: E402
    dequantize_ref, ids_agree_up_to_ties, quant_topk_ref)
from repro_torch.quant.codec import quantize_groups  # noqa: E402

RTOL = 1e-5

QUANT_SWEEP = [(1, 100, 16, 16, 1), (7, 333, 128, 32, 10),
               (37, 500, 960, 64, 5), (128, 256, 64, 32, 16),
               (130, 513, 32, 8, 3)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernel entry points (imported here, not at module
    level, so the ``gpu`` tests also run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.gather_blocks.ops import gather_blocks
    from repro.kernels.quant_topk.ops import quant_topk
    from repro.kernels.quant_topk.ref import quant_topk_ref as jref

    class Ref:
        pass
    r = Ref()
    r.jnp, r.gather, r.quant_topk, r.quant_topk_ref = (jnp, gather_blocks,
                                                        quant_topk, jref)
    return r


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _quant_inputs(rng, B, N, D, group):
    q = rng.standard_normal((B, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    codes, scales = quantize_groups(x, group)
    return q, codes, scales


def _assert_topk(d, i, d_ref_ext, i_ref_ext, atol=0.0):
    k = i.shape[1]
    ok, n = ids_agree_up_to_ties(i, i_ref_ext, d_ref_ext, rtol=RTOL)
    assert ok, f"{n} ids differ beyond ties"
    live = np.isfinite(d_ref_ext[:, :k])
    assert (np.isfinite(d) == live).all()
    np.testing.assert_allclose(d[live], d_ref_ext[:, :k][live], rtol=RTOL,
                               atol=atol)
    assert (i[~live] == -1).all()


def _jax_ref_ext(ref, q, codes, scales, k, group, n_valid=None):
    """The reference's plain top-(k+1): the list the tie rule reads."""
    jnp = ref.jnp
    N = codes.shape[0]
    kk = min(k + 1, N)
    dr, ir = ref.quant_topk_ref(jnp.asarray(q), jnp.asarray(codes),
                                jnp.asarray(scales), kk, group,
                                N if n_valid is None else n_valid)
    dr, ir = np.asarray(dr), np.asarray(ir)
    if kk < k + 1:
        dr = np.concatenate([dr, np.full((len(dr), k + 1 - kk), np.inf)], 1)
        ir = np.concatenate([ir, np.full((len(ir), k + 1 - kk), -1)], 1)
    bad = ~np.isfinite(dr)
    return dr, np.where(bad, -1, ir)


# ------------------------------------------------------------ gather_blocks

@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8])
@pytest.mark.parametrize("m", [1, 5, 64])
def test_gather_blocks_matches_reference(ref, rng, dtype, m):
    buf = (rng.standard_normal((40, 192)) * 100).astype(dtype)
    ids = rng.integers(0, 40, m).astype(np.int32)
    want = np.asarray(ref.gather(ref.jnp.asarray(buf), ref.jnp.asarray(ids)))
    got = GO.gather_blocks(torch.from_numpy(buf), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather_blocks_ref(torch.from_numpy(buf), torch.from_numpy(ids)).numpy(),
        want)


def test_gather_blocks_repeated_ids_matches_reference(ref, rng):
    buf = rng.standard_normal((16, 64)).astype(np.float32)
    ids = np.array([3, 3, 3, 0, 15, 3], np.int32)
    want = np.asarray(ref.gather(ref.jnp.asarray(buf), ref.jnp.asarray(ids)))
    got = GO.gather_blocks(torch.from_numpy(buf), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_blocks_checks_inputs():
    buf = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        GO.gather_blocks(buf[0], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        GO.gather_blocks(buf, torch.zeros((2, 2), dtype=torch.int32))


def test_gather_blocks_out_of_range_raises():
    buf = torch.zeros((4, 8))
    for bad in ([1, 4], [-1, 0]):
        with pytest.raises(IndexError):
            GO.gather_blocks(buf, torch.tensor(bad, dtype=torch.int32))


def test_cpu_wrappers_launch_nothing(rng):
    """On the CPU the wrappers take the plain versions and count no
    launch."""
    GO.launches = QO.launches = 0
    GO.gather_blocks(torch.zeros((4, 8)), torch.tensor([1, 2]))
    q, codes, scales = _quant_inputs(rng, 3, 50, 16, 8)
    QO.quant_topk(torch.from_numpy(q), torch.from_numpy(codes),
                  torch.from_numpy(scales), 4, 8)
    assert GO.launches == 0 and QO.launches == 0


# ------------------------------------------------------------- quant_topk

@pytest.mark.parametrize("B,N,D,group,k", QUANT_SWEEP)
def test_quant_topk_matches_reference(ref, rng, B, N, D, group, k):
    jnp = ref.jnp
    q, codes, scales = _quant_inputs(rng, B, N, D, group)
    d, i = ref.quant_topk(jnp.asarray(q), jnp.asarray(codes),
                          jnp.asarray(scales), k, group)
    d_ext, i_ext = _jax_ref_ext(ref, q, codes, scales, k, group)
    # the reference kernel itself agrees with its own plain version
    _assert_topk(np.asarray(d), np.asarray(i), d_ext, i_ext, atol=1e-4)
    pd, pi = QO.quant_topk(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scales), k, group)
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    _assert_topk(pd.numpy(), pi.numpy(), np.concatenate(
        [np.asarray(d), d_ext[:, k:]], 1), np.concatenate(
        [np.asarray(i), i_ext[:, k:]], 1), atol=1e-4)


@pytest.mark.parametrize("n_valid", [1, 50, 255, 256])
def test_quant_topk_masking_matches_reference(ref, rng, n_valid):
    jnp = ref.jnp
    q, codes, scales = _quant_inputs(rng, 5, 256, 32, 8)
    d, i = ref.quant_topk(jnp.asarray(q), jnp.asarray(codes),
                          jnp.asarray(scales), 8, 8, n_valid=n_valid)
    pd, pi = QO.quant_topk(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scales), 8, 8, n_valid=n_valid)
    d_ext, i_ext = _jax_ref_ext(ref, q, codes, scales, 8, 8, n_valid)
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    live = pi.numpy() >= 0
    assert (pi.numpy()[live] < n_valid).all()
    np.testing.assert_array_equal(pi.numpy() >= 0, np.asarray(i) >= 0)
    if n_valid < 8:          # padding semantics: inf/-1 tail
        assert np.isinf(pd.numpy()[:, n_valid:]).all()
        assert (pi.numpy()[:, n_valid:] == -1).all()


@pytest.mark.parametrize("B,N,D,group,k", QUANT_SWEEP[:3])
def test_quant_topk_use_ref_is_the_plain_version(ref, rng, B, N, D, group,
                                                 k):
    """``use_ref=True`` returns the plain version's raw result, as the
    reference wrapper does, and the plain versions agree."""
    jnp = ref.jnp
    q, codes, scales = _quant_inputs(rng, B, N, D, group)
    dj, ij = ref.quant_topk(jnp.asarray(q), jnp.asarray(codes),
                            jnp.asarray(scales), k, group, use_ref=True)
    pd, pi = QO.quant_topk(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scales), k, group, use_ref=True)
    d_ext, i_ext = _jax_ref_ext(ref, q, codes, scales, k, group)
    _assert_topk(pd.numpy(), pi.numpy(), d_ext, i_ext)
    np.testing.assert_allclose(pd.numpy(), np.asarray(dj), rtol=RTOL)
    x = dequantize_ref(torch.from_numpy(codes), torch.from_numpy(scales),
                       group)
    np.testing.assert_array_equal(
        x.numpy(), (codes.astype(np.float32).reshape(N, D // group, group)
                    * scales[:, :, None]).reshape(N, D))


def test_quant_topk_k_past_rows(rng):
    """k larger than N: the kernel's contract pads with inf/-1."""
    q, codes, scales = _quant_inputs(rng, 3, 5, 16, 8)
    d, i = QO.quant_topk(torch.from_numpy(q), torch.from_numpy(codes),
                         torch.from_numpy(scales), 8, 8)
    assert d.shape == (3, 8)
    assert np.isinf(d[:, 5:].numpy()).all() and (i[:, 5:] == -1).all()
    assert sorted(i[0, :5].tolist()) == list(range(5))


def test_build_hash_covers_headers(tmp_path):
    """The library's name hashes every source and every header, so an edit
    to a shared ``.cuh`` never loads a stale build; only ``.cu`` files are
    compiled."""
    import shutil

    from repro_torch.kernels import _build
    kernels = tmp_path / "kernels"
    shutil.copytree(_build.KERNELS_DIR, kernels,
                    ignore=shutil.ignore_patterns("__pycache__"))
    headers = sorted(kernels.glob("csrc/*.cuh"))
    assert headers, "no shared header found"
    assert all(p.suffix == ".cu" for p in _build.sources(kernels))
    assert set(headers) <= set(_build.hashed_files(kernels))
    before = _build.library_path(kernels)
    assert before == _build.library_path(kernels)
    assert before.name == _build.library_path().name
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert _build.library_path(kernels) != before


def test_ids_agree_up_to_ties():
    ref_d = np.array([[1.0, 2.0, 2.0, 3.0]])
    ref_i = np.array([[7, 8, 9, 10]])
    assert ids_agree_up_to_ties(np.array([[7, 9, 8]]), ref_i, ref_d)[0]
    assert not ids_agree_up_to_ties(np.array([[8, 7, 9]]), ref_i, ref_d)[0]
    assert not ids_agree_up_to_ties(np.array([[7, 8, 10]]), ref_i, ref_d)[0]


# ------------------------------------------------------ on the card (gpu)

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,blk", [(torch.float32, 8192),
                                       (torch.int32, 1088),
                                       (torch.int8, 8192),
                                       (torch.float32, 256),
                                       (torch.int8, 193)])
@pytest.mark.parametrize("m", [1, 5, 528])
def test_gather_blocks_kernel_on_card(dtype, blk, m):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    n_blocks = 600
    if dtype.is_floating_point:
        buf = torch.randn((n_blocks, blk), generator=g, device=dev).to(dtype)
    else:
        buf = torch.randint(-100, 100, (n_blocks, blk), generator=g,
                            device=dev).to(dtype)
    ids = torch.randint(0, n_blocks, (m,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[: m // 2] = ids[0]                      # repeated ids
    before = GO.launches
    got = GO.gather_blocks(buf, ids)
    torch.cuda.synchronize()
    assert GO.launches == before + 1
    assert torch.equal(got, gather_blocks_ref(buf, ids))


@pytest.mark.gpu
@pytest.mark.parametrize("bad_id", [600, -1])
def test_gather_blocks_kernel_out_of_range_raises(bad_id):
    """An id past either end raises on the card as on the CPU, and the
    device stays usable."""
    dev = _cuda()
    buf = torch.arange(600 * 64, dtype=torch.float32, device=dev).reshape(
        600, 64)
    ids = torch.tensor([3, bad_id, 7], dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):
        GO.gather_blocks(buf, ids)
    with pytest.raises(IndexError):
        gather_blocks_ref(buf.cpu(), ids.cpu())
    ok = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    assert torch.equal(GO.gather_blocks(buf, ok), buf[[3, 7]])


def _twin_rows(x, codes=None):
    """Make the second half of the rows copies of the first half, and row 1
    a copy of row 0: equal distances across tiles, chunks and inside one
    tile.  Returns the id each row copies (its own id for the originals)."""
    N = len(codes if codes is not None else x)
    half = N // 2
    for a in (x, codes):
        if a is not None:
            a[1] = a[0]
            a[half:2 * half] = a[:half]
    twin = np.arange(N)
    twin[1] = 0
    twin[half:2 * half] = twin[:half]
    return twin


def _assert_ties_to_lower_id(d, i, twin):
    """The lists are ascending by (distance, id), and a copied row never
    comes before (or without) the row it copies: equal distances go to the
    lower id."""
    for b in range(len(d)):
        live = i[b] >= 0
        db, ib = d[b][live], i[b][live]
        assert (np.diff(db) >= 0).all()
        assert (ib[1:][db[1:] == db[:-1]] > ib[:-1][db[1:] == db[:-1]]).all()
        pos = {int(v): p for p, v in enumerate(ib)}
        for v, p in pos.items():
            if twin[v] != v:
                assert pos.get(int(twin[v]), len(ib)) < p, (b, v, twin[v])


def _quant_case_on_card(B, N, D, group, k, n_valid, twins=False, tile=None,
                        S=None):
    """quant_topk on the card against its plain version: through the
    wrapper (one launch counted) or, with ``tile``, one raw launch at that
    tile and ``S`` chunks."""
    dev = _cuda()
    rng = np.random.default_rng(B * 7 + N)
    q, codes, scales = _quant_inputs(rng, B, N, D, group)
    twin = _twin_rows(scales, codes) if twins else None
    qt, ct, st = (torch.from_numpy(a).to(dev) for a in (q, codes, scales))
    nv = N if n_valid is None else n_valid
    if tile is None:
        before = QO.launches
        d, i = QO.quant_topk(qt, ct, st, k, group, n_valid=n_valid)
        torch.cuda.synchronize()
        assert QO.launches == before + 1
    else:
        bufs = QO.buffers(B, k, S, dev)
        QO._launch(qt, ct, st, k, group, nv, bufs, tile, S)
        torch.cuda.synchronize()
        d, i = bufs[2], bufs[3]
    kk = min(k + 1, N)
    dr, ir = quant_topk_ref(qt, ct, st, kk, group, nv)
    dr, ir = dr.cpu().numpy(), ir.cpu().numpy()
    if kk < k + 1:
        dr = np.concatenate([dr, np.full((B, k + 1 - kk), np.inf)], 1)
        ir = np.concatenate([ir, np.full((B, k + 1 - kk), -1)], 1)
    ir = np.where(np.isfinite(dr), ir, -1)
    _assert_topk(d.cpu().numpy(), i.cpu().numpy(), dr, ir, atol=1e-3)
    if twins:
        _assert_ties_to_lower_id(d.cpu().numpy(), i.cpu().numpy(), twin)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,D,group,k,n_valid,twins,tile,S", [
    *[(B, N, D, g, k, None, False, None, None)
      for B, N, D, g, k in QUANT_SWEEP],
    (5, 256, 32, 8, 8, 1, False, None, None),
    (5, 256, 32, 8, 8, 50, False, None, None),
    (3, 5, 16, 8, 8, None, False, None, None),
    (70, 3000, 128, 32, 128, 2900, False, None, None),
    (2000, 20000, 128, 32, 20, 19000, False, None, None),
    # equal distances across tiles, chunks and inside a tile
    (300, 20000, 128, 32, 20, None, True, None, None),
    (129, 5000, 64, 16, 16, 4999, True, 128, 3),
    (129, 5000, 64, 16, 16, 4999, True, 64, 7),
    # k = K_MAX with n_valid inside a tile; B not a multiple of either tile
    (130, 1000, 64, 16, 128, 777, False, None, None),
    (65, 3000, 32, 8, 128, 2001, True, 64, 4),
    # D = 960; rows of 40 and 36 bytes (8- and 4-byte copies)
    (37, 2000, 960, 64, 10, None, True, None, None),
    (200, 3000, 960, 32, 10, 2999, False, 128, 2),
    (77, 3000, 40, 8, 10, None, True, None, None),
    (77, 3000, 40, 8, 10, None, False, 128, 3),
    (77, 3000, 36, 4, 10, 2900, True, 64, 5),
    (133, 1500, 24, 8, 128, None, False, 64, 2)])
def test_quant_topk_kernel_on_card(B, N, D, group, k, n_valid, twins, tile,
                                   S):
    _quant_case_on_card(B, N, D, group, k, n_valid, twins, tile, S)


@pytest.mark.gpu
def test_quant_topk_kernel_queued_launches_on_card():
    """Twenty launches queued on one stream with no sync between them, at
    the wrappers' cut and at the 128 x 128 tile, each give what one launch
    of theirs gave: the chunk merge's arrival counters are left at 0 by
    every launch."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    q, codes, scales = (torch.from_numpy(a).to(dev)
                        for a in _quant_inputs(rng, 300, 20000, 128, 32))
    assert QO.launch_shape(300, 20000, 20, True)[1] > 1
    one = QO.quant_topk(q, codes, scales, 20, 32)
    b1 = QO.buffers(300, 20, 3, dev)
    QO._launch(q, codes, scales, 20, 32, 20000, b1, 128, 3)
    torch.cuda.synchronize()
    before = QO.launches
    outs = [QO.quant_topk(q, codes, scales, 20, 32) for _ in range(20)]
    bufs = [QO.buffers(300, 20, 3, dev) for _ in range(20)]
    for b in bufs:
        QO._launch(q, codes, scales, 20, 32, 20000, b, 128, 3)
    torch.cuda.synchronize()
    assert QO.launches == before + 20
    for d, i in outs:
        assert torch.equal(d, one[0]) and torch.equal(i, one[1])
    for b in bufs:
        assert torch.equal(b[2], b1[2]) and torch.equal(b[3], b1[3])
    assert not QO.arrivals(dev, 1).any()

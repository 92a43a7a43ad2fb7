"""The port's span gather (``gather_spans``: one launch per span read, over
one to three buffers) against the JAX package's ``gather_blocks`` per
buffer, and against its plain torch version on the card.

On the CPU the wrapper runs its plain version (``index_select`` per
buffer); each of its outputs is held against the reference's
``gather_blocks`` (Pallas in interpret mode, as ``tests/test_kernels.py``
runs it) on the same buffer with the same numpy-seeded ids.  Gathers are
exact copies, so every comparison is exact.  ``LocalPool.read_spans``,
which now makes one ``gather_spans`` call per span read, returns what an
``index_select`` per staged buffer returns, in both ``quant`` modes.

Tests marked ``gpu`` hold the CUDA kernel against its plain version on
the card; they decide inside the test whether a card exists and skip
here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gather_blocks import ops as GO  # noqa: E402
from repro_torch.kernels.gather_blocks.ref import (  # noqa: E402
    gather_blocks_ref, gather_spans_ref)

# buffer sets of one span read: (dtype, row width) per buffer; the exact
# paths' pair, the int8 per-pair path's triple, and odd row widths
BUFSETS = {
    "exact": [(np.int32, 68), (np.float32, 256)],
    "int8": [(np.int32, 68), (np.int8, 256), (np.float32, 8)],
    "odd": [(np.int8, 193), (np.float32, 7), (np.int32, 3)],
}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's gather (imported here, so the ``gpu`` tests also
    run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.gather_blocks.ops import gather_blocks
    return lambda buf, ids: np.asarray(gather_blocks(jnp.asarray(buf),
                                                     jnp.asarray(ids)))


def _bufs(rng, spec, n_blocks=40):
    return [(rng.standard_normal((n_blocks, w)) * 100).astype(dt)
            for dt, w in spec]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("bufset", sorted(BUFSETS))
@pytest.mark.parametrize("m", [1, 5, 64])
def test_gather_spans_matches_reference(ref, rng, bufset, m):
    bufs = _bufs(rng, BUFSETS[bufset])
    ids = rng.integers(0, 40, m).astype(np.int32)
    got = GO.gather_spans([torch.from_numpy(b) for b in bufs],
                          torch.from_numpy(ids))
    assert len(got) == len(bufs)
    for b, g in zip(bufs, got):
        want = ref(b, ids)
        assert g.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("bufset", sorted(BUFSETS))
def test_gather_spans_repeated_ids_match_reference(ref, rng, bufset):
    bufs = _bufs(rng, BUFSETS[bufset], n_blocks=16)
    ids = np.array([3, 3, 3, 0, 15, 3], np.int32)
    got = GO.gather_spans([torch.from_numpy(b) for b in bufs],
                          torch.from_numpy(ids))
    for b, g in zip(bufs, got):
        np.testing.assert_array_equal(g.numpy(), ref(b, ids))


@pytest.mark.parametrize("bad", [[1, 40], [-1, 0], [39, 41, 2]])
def test_gather_spans_out_of_range_raises(rng, bad):
    bufs = [torch.from_numpy(b) for b in _bufs(rng, BUFSETS["int8"])]
    with pytest.raises(IndexError):
        GO.gather_spans(bufs, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(IndexError):
        gather_spans_ref(bufs, torch.tensor(bad, dtype=torch.int32))


def test_gather_spans_checks_inputs_and_launches_nothing_on_cpu():
    buf = torch.zeros((4, 8))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        GO.gather_spans([], ids)
    with pytest.raises(ValueError):
        GO.gather_spans([buf] * 4, ids)
    with pytest.raises(ValueError):
        GO.gather_spans([buf, buf[0]], ids)
    with pytest.raises(ValueError):
        GO.gather_spans([buf], ids[None])
    GO.launches = 0
    out = GO.gather_spans([buf, buf.int()], ids)
    assert GO.launches == 0 and [o.shape for o in out] == [(2, 8)] * 2
    assert torch.equal(GO.gather_blocks(buf, ids), gather_blocks_ref(buf, ids))


@pytest.fixture(scope="module")
def pool():
    """A port engine's LocalPool over a small index, with the int8 mirror
    staged, and the gather kernel's wrapper on."""
    from repro_torch import DHNSWEngine, EngineConfig
    from repro_torch.data.synthetic import sift_like
    ds = sift_like(n=600, n_queries=4, seed=1)
    eng = DHNSWEngine(EngineConfig(n_rep=8, b=2, quant="int8",
                                   quant_kernel="off", cache_frac=0.25,
                                   use_gather_kernel=True),
                      device="cpu").build(ds.data)
    return eng.pool


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pids", [[0], [3, 1, 3], [7, 0, 5, 2]])
def test_read_spans_returns_the_buffers_rows(pool, quant, pids):
    """One ``gather_spans`` call per span read returns what an
    ``index_select`` per staged buffer returned, with the same shapes and
    dtypes, and the same counted verbs."""
    spec = pool.spec
    assert pool.use_gather_kernel
    ids = torch.as_tensor(np.concatenate(
        [pool.store.span_block_ids(p) for p in pids]).astype(np.int32))
    bufs = ((pool._g_dev, pool._qv_dev, pool._qs_dev) if quant
            else (pool._g_dev, pool._v_dev))
    widths = ((spec.gblk, spec.vblk, spec.n_qgroups) if quant
              else (spec.gblk, spec.vblk))
    before = dict(pool.verbs)
    got = pool.read_spans(np.array(pids), ledger=None, doorbell=4,
                          quant=quant)
    assert len(got) == len(bufs)
    for g, buf, w in zip(got, bufs, widths):
        want = buf.index_select(0, ids.long()).reshape(len(pids), -1, w)
        assert g.dtype == buf.dtype and torch.equal(g, want)
    verb = "read_spans_quant" if quant else "read_spans"
    assert pool.verbs[verb] == before.get(verb, 0) + len(pids)
    pool.use_gather_kernel = False
    try:
        off = pool.read_spans(np.array(pids), ledger=None, doorbell=4,
                              quant=quant)
    finally:
        pool.use_gather_kernel = True
    assert all(torch.equal(a, b) for a, b in zip(got, off))


# ------------------------------------------------------ on the card (gpu)

def _card_bufs(dev, spec, n_blocks=600):
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for dtype, w in spec:
        if dtype.is_floating_point:
            out.append(torch.randn((n_blocks, w), generator=g,
                                   device=dev).to(dtype))
        else:
            out.append(torch.randint(-100, 100, (n_blocks, w), generator=g,
                                     device=dev).to(dtype))
    return out


def _shifted(buf):
    """A contiguous copy of ``buf`` that starts one element past a 16-byte
    boundary."""
    store = torch.empty(buf.numel() + 1, dtype=buf.dtype, device=buf.device)
    out = store[1:].view(buf.shape)
    out.copy_(buf)
    return out


CARD_BUFSETS = {
    # the paths' rows: 4352-byte graph blocks, 32 KB vector blocks, 8 KB
    # int8 codes, 1 KB scales
    "exact": [(torch.int32, 1088), (torch.float32, 8192)],
    "int8": [(torch.int32, 1088), (torch.int8, 8192), (torch.float32, 256)],
    "odd": [(torch.int8, 193), (torch.float32, 7), (torch.int32, 3)],
    "one": [(torch.int8, 8192)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("bufset", sorted(CARD_BUFSETS))
@pytest.mark.parametrize("m", [1, 5, 528, 6204])
def test_gather_spans_kernel_on_card(bufset, m):
    dev = _cuda()
    bufs = _card_bufs(dev, CARD_BUFSETS[bufset])
    g = torch.Generator(device=dev).manual_seed(m)
    ids = torch.randint(0, 600, (m,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[: m // 2] = ids[0]                      # repeated ids
    before = GO.launches
    got = GO.gather_spans(bufs, ids)
    torch.cuda.synchronize()
    assert GO.launches == before + 1            # one launch for all buffers
    for b, o in zip(bufs, got):
        assert torch.equal(o, gather_blocks_ref(b, ids))
    # buffers whose base is off by one element take narrower words in the
    # same kernel
    shifted = [_shifted(b) for b in bufs]
    assert all(b.data_ptr() % 16 for b in shifted)
    for b, o in zip(shifted, GO.gather_spans(shifted, ids)):
        assert torch.equal(o, gather_blocks_ref(b, ids))


@pytest.mark.gpu
@pytest.mark.parametrize("bad_id", [600, -1])
def test_gather_spans_kernel_out_of_range_raises(bad_id):
    """An id past either end raises on the card as on the CPU, the flag is
    reset, and the next call succeeds."""
    dev = _cuda()
    bufs = _card_bufs(dev, CARD_BUFSETS["int8"])
    ids = torch.tensor([3, bad_id, 7], dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):
        GO.gather_spans(bufs, ids)
    with pytest.raises(IndexError):
        gather_spans_ref([b.cpu() for b in bufs], ids.cpu())
    assert int(GO.flag(ids.device).item()) == 0
    ok = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    for b, o in zip(bufs, GO.gather_spans(bufs, ok)):
        assert torch.equal(o, b[[3, 7]])

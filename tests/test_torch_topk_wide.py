"""The two top-k kernels (``quant_topk``, ``distance_topk``) at every k,
group and D the reference serves: k past the tiled kernel's lists (the
large-k route: the product into a distance matrix, then a per-query
radix select), codec groups that are not a multiple of 4 (each code its
own scale), and rows of D % 4 != 0 (zero-padded by the wrapper).

The ``gpu`` tests hold each call on the card against the plain version
on the same inputs: ids equal up to ties within 1e-5 relative, distances
within rtol 1e-5 / atol 1e-3, ties going to the lower id.  They need
neither ``triton`` nor JAX.  The CPU tests pin the wrappers' host-side
policy: which route a k takes, the blocks and scratch of the large-k
route, and the padding layout step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.distance_topk import ops as DO  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
from repro_torch.kernels.quant_topk.ref import (  # noqa: E402
    dequantize_ref, ids_agree_up_to_ties, quant_topk_ref)
from repro_torch.quant.codec import quantize_groups  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _want_launches(B: int, k: int, n_valid: int) -> int:
    """Kernel launches of one wrapper call: one for the tiled top-k, two
    per block of queries on the large-k route (no product when no row is
    valid)."""
    if k <= QO.K_MAX:
        return 1
    blocks = -(-B // QO.select_blocks(B, n_valid))
    return blocks * (2 if n_valid else 1)


def _check(d, i, dr, ir, k: int, twin=None) -> None:
    """Kernel lists (k) against the plain version's (k + 1, padded with
    inf/-1): ids up to ties, distances within tolerance, and rows that
    copy another never ahead of (or without) it."""
    d, i = d.cpu().numpy(), i.cpu().numpy()
    dr, ir = dr.cpu().numpy(), ir.cpu().numpy()
    B = d.shape[0]
    if dr.shape[1] < k + 1:
        pad = k + 1 - dr.shape[1]
        dr = np.concatenate([dr, np.full((B, pad), np.inf, np.float32)], 1)
        ir = np.concatenate([ir, np.full((B, pad), -1, ir.dtype)], 1)
    ir = np.where(np.isfinite(dr), ir, -1)
    ok, n_diff = ids_agree_up_to_ties(i, ir, dr, rtol=RTOL)
    assert ok, f"{n_diff} ids differ beyond ties"
    np.testing.assert_allclose(d, dr[:, :k], rtol=RTOL, atol=ATOL)
    for b in range(B):
        live = i[b] >= 0
        db, ib = d[b][live], i[b][live]
        assert (np.diff(db) >= 0).all()
        same = db[1:] == db[:-1]
        assert (ib[1:][same] > ib[:-1][same]).all()
        if twin is not None:
            pos = {int(v): p for p, v in enumerate(ib)}
            for v, p in pos.items():
                if twin[v] != v:
                    assert pos.get(int(twin[v]), len(ib)) < p


def _twins(a, b=None):
    """Rows of the second half copy the first half's, row 1 copies row 0;
    returns the id each row copies."""
    N = len(a)
    half = N // 2
    for x in (a, b):
        if x is not None:
            x[1] = x[0]
            x[half:2 * half] = x[:half]
    twin = np.arange(N)
    twin[1] = 0
    twin[half:2 * half] = twin[:half]
    return twin


# (B, N, D, group, k, n_valid, twins)
QUANT_CASES = [
    (300, 5000, 128, 32, 129, None, False),
    (300, 5000, 128, 32, 256, 4321, True),
    (70, 6000, 128, 32, 1024, None, False),
    (9, 40, 32, 8, 40, None, False),        # k = n_valid on a small N
    (9, 40, 32, 8, 37, 37, True),           # k = n_valid below N
    (5, 30, 16, 4, 64, 25, False),          # k > n_valid: inf / -1 tail
    (130, 3000, 128, 2, 20, None, True),    # group 2, tiled route
    (130, 3000, 96, 6, 20, 2999, False),    # group 6
    (130, 3000, 96, 6, 256, None, False),   # group 6, large k
    (77, 2000, 102, 2, 10, None, True),     # D = 102
    (77, 2000, 102, 6, 10, 1999, False),
    (77, 2000, 102, 51, 10, None, False),
    (77, 2000, 102, 2, 200, None, False),   # D = 102, large k
    (2, 20000, 64, 16, 20000, None, False),  # a sort past shared memory
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,D,group,k,n_valid,twins", QUANT_CASES)
def test_quant_topk_every_k_group_and_d_on_card(B, N, D, group, k, n_valid,
                                                twins):
    dev = _cuda()
    rng = np.random.default_rng(B * 31 + N + D + k)
    q = rng.standard_normal((B, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    codes, scales = quantize_groups(x, group)
    twin = _twins(codes, scales) if twins else None
    qt, ct, st = (torch.from_numpy(a).to(dev) for a in (q, codes, scales))
    nv = N if n_valid is None else n_valid
    before = QO.launches
    d, i = QO.quant_topk(qt, ct, st, k, group, n_valid=n_valid)
    torch.cuda.synchronize()
    assert QO.launches == before + _want_launches(B, k, nv)
    assert d.shape == i.shape == (B, k) and i.dtype == torch.int32
    dr, ir = quant_topk_ref(qt, ct, st, min(k + 1, N), group, nv)
    _check(d, i, dr, ir, k, twin)


DIST_CASES = [
    (128, 4096, 128, 129, None, False),
    (128, 4096, 128, 256, 4000, True),
    (50, 5000, 64, 1024, None, False),
    (6, 50, 24, 50, None, False),           # k = n_valid on a small N
    (77, 2000, 102, 10, None, True),        # D = 102, tiled route
    (77, 2000, 102, 300, 1999, False),      # D = 102, large k
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,D,k,n_valid,twins", DIST_CASES)
def test_distance_topk_every_k_and_d_on_card(B, N, D, k, n_valid, twins):
    dev = _cuda()
    rng = np.random.default_rng(B * 17 + N + D + k)
    q = rng.standard_normal((B, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    twin = _twins(x) if twins else None
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    nv = N if n_valid is None else n_valid
    before = DO.launches
    d, i = DO.distance_topk(qt, xt, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert DO.launches == before + _want_launches(B, k, nv)
    dr, ir = distance_topk_ref(qt, xt, min(k + 1, N), nv)
    _check(d, i, dr, ir, k, twin)


@pytest.mark.gpu
def test_large_k_route_in_blocks_on_card(monkeypatch):
    """A distance matrix over SELECT_BYTES is taken in blocks of queries,
    each a product and a select: the lists equal one block's."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((100, 64)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32))
    q, x = q.to(dev), x.to(dev)
    one = DO.distance_topk(q, x, 200)
    monkeypatch.setattr(QO, "SELECT_BYTES", 4 * 3000 * 30)
    assert QO.select_blocks(100, 3000) == 30
    before = DO.launches
    got = DO.distance_topk(q, x, 200)
    torch.cuda.synchronize()
    assert DO.launches == before + 8
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("k,want", [(1, 1), (128, 1), (129, 2), (1024, 2)])
def test_route_by_k(k, want):
    """k <= K_MAX is one launch of the tiled kernel; larger k, two (the
    product and the select) for each block of queries."""
    assert QO.K_MAX == 128
    assert _want_launches(2000, k, 100000) == want


def test_select_blocks_and_scratch():
    """The large-k route keeps its distance matrix under SELECT_BYTES and
    sorts lists of up to SORT_SMEM entries in shared memory."""
    assert QO.select_blocks(2000, 100000) == 2000
    assert QO.select_blocks(2000, 1_000_000) == QO.SELECT_BYTES // 4_000_000
    assert QO.select_blocks(3, 0) == 3
    dev = torch.device("cpu")
    assert QO.select_scratch(8, 256, 100000, dev) is None
    assert QO.select_scratch(8, QO.SORT_SMEM, 100000, dev) is None
    s = QO.select_scratch(8, QO.SORT_SMEM + 1, 100000, dev)
    assert s.shape == (8, 2 * QO.SORT_SMEM) and s.dtype == torch.int64
    assert QO.select_scratch(8, 50000, 20000, dev).shape == (8, 32768)


def test_select_constants_match_the_kernel():
    src = (_build.KERNELS_DIR / "quant_topk" / "csrc" /
           "topk_select.cu").read_text()
    assert f"constexpr int kSortSmem = {QO.SORT_SMEM};" in src
    for name in ("quant_distances_launch", "f32_distances_launch",
                 "topk_select_launch"):
        assert name in _build.SIGNATURES


@pytest.mark.parametrize("D,group", [(102, 2), (102, 6), (102, 51),
                                     (128, 32), (30, 3)])
def test_padding_is_a_layout_step(D, group):
    """kernel_layout zero-pads rows of D % 4 != 0 codes (and the queries)
    to a multiple of 4 and leaves the scales: the distances over the
    padded rows, with the padding given the row's last scale as the
    kernel gives it, equal the unpadded ones."""
    rng = np.random.default_rng(D + group)
    q = torch.from_numpy(rng.standard_normal((5, D)).astype(np.float32))
    codes, scales = quantize_groups(
        rng.standard_normal((40, D)).astype(np.float32), group)
    c, s = torch.from_numpy(codes), torch.from_numpy(scales)
    qp, cp, sp = QO.kernel_layout(q, c, s)
    D4 = -(-D // 4) * 4
    assert qp.shape == (5, D4) and cp.shape == (40, D4)
    assert torch.equal(sp, s) and qp.data_ptr() % 16 == 0
    assert not qp[:, D:].any() and not cp[:, D:].any()
    assert torch.equal(cp[:, :D], c) and torch.equal(qp[:, :D], q)
    # the kernel's scale of column j: min(j // group, n_groups - 1)
    col = torch.clamp(torch.arange(D4) // group, max=s.shape[1] - 1)
    x = cp.float() * sp[:, col]
    d = ((qp[:, None, :] - x[None]) ** 2).sum(-1)
    want = ((q[:, None, :] - dequantize_ref(c, s, group)[None]) ** 2).sum(-1)
    torch.testing.assert_close(d, want, rtol=1e-6, atol=1e-6)

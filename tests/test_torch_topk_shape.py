"""The launch shape of the two top-k kernels (``quant_topk``,
``distance_topk``): plain Python that both wrappers and ``chip_smoke.py``
call, pinned here at the paths' shapes, with the scratch it makes the
wrappers allocate and the constants it shares with
``kernels/csrc/topk_tile.cuh``."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402

# (B, n_valid, k, quant): the int8 flat stage 1 and its f32 twin, the
# throughput benchmark's kernel row, the gpu tests' shapes, and edges
SHAPES = [(2000, 100000, 20, True), (2000, 100000, 20, False),
          (128, 4096, 10, False), (2000, 19000, 20, True),
          (70, 2900, 128, True), (70, 2900, 128, False), (1, 100, 1, False),
          (130, 513, 3, True), (300, 20000, 20, False), (1, 1, 1, True),
          (4, 3, 8, False), (2000, 100000, 128, True),
          (5000, 1_000_000, 10, False)]


@pytest.mark.parametrize("B,n_valid,k,quant,want", [
    (2000, 100000, 20, True, (128, 8)),     # int8 flat: one wave, 128 CTAs
    (2000, 100000, 20, False, (128, 8)),    # its f32 twin
    (128, 4096, 10, False, (64, 32)),       # the throughput kernel row
])
def test_launch_shape_at_the_paths_shapes(B, n_valid, k, quant, want):
    assert QO.launch_shape(B, n_valid, k, quant) == want


@pytest.mark.parametrize("B,n_valid,k,quant", SHAPES)
def test_launch_shape_chunks_hold_rows(B, n_valid, k, quant):
    """Every chunk the kernel derives from S holds rows, no chunk is
    shorter than MIN_TILES tiles unless there is one chunk, and the tile
    fits the SM."""
    tile, S = QO.launch_shape(B, n_valid, k, quant)
    assert tile in QO.TILES and 1 <= S <= 65535
    n_tiles = max(-(-n_valid // tile), 1)
    per = -(-n_tiles // S)            # as topk_tile.cuh cuts the rows
    assert (S - 1) * per < n_tiles <= S * per
    assert S == 1 or per >= QO.MIN_TILES
    assert QO.smem_bytes(tile, k, quant) <= QO.SMEM_MAX
    assert QO.ctas_per_sm(tile, k, quant) >= 1


@pytest.mark.parametrize("B,n_valid,k,quant", SHAPES[:6])
def test_buffers_have_the_kernels_shapes(B, n_valid, k, quant):
    tile, S = QO.launch_shape(B, n_valid, k, quant)
    part_d, part_i, out_d, out_i = QO.buffers(B, k, S, torch.device("cpu"))
    assert part_d.shape == part_i.shape == (B, S, k)
    assert out_d.shape == out_i.shape == (B, k)
    assert part_d.dtype == out_d.dtype == torch.float32
    assert part_i.dtype == out_i.dtype == torch.int32


def test_large_k_takes_the_small_tile():
    """At k = K_MAX the 128 x 128 tile's lists do not fit in shared
    memory: the policy never picks a tile that does not fit."""
    for quant in (True, False):
        assert QO.smem_bytes(128, QO.K_MAX, quant) > QO.SMEM_MAX
        assert QO.ctas_per_sm(128, QO.K_MAX, quant) == 0
        assert QO.launch_shape(2000, 100000, QO.K_MAX, quant)[0] == 64


def test_shape_constants_match_the_kernel():
    """The sizes the policy computes shared memory and occupancy from are
    the kernel's."""
    src = (_build.KERNELS_DIR / "csrc" / "topk_tile.cuh").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads128"] == QO._SHAPE[128]["threads"]
    assert "BQ == 128 ? kThreads128 : 256" in src
    assert QO._SHAPE[64]["threads"] == 256
    assert const["kDK"] == QO._DK
    assert const["kRing128"] == QO._SHAPE[128]["ring"]
    assert const["kRing64"] == QO._SHAPE[64]["ring"]
    assert const["kC"] == QO._CAND
    assert const["kMaxK"] == QO.K_MAX
    assert "kLd = kDK + 4;" in src and "kMaxSG = kDK / 4;" in src
    for tile in QO.TILES:
        assert f"TOPK_TILE_LAUNCH({tile}, 16)" in src
    # registers: 512 threads of at most 128 (``__launch_bounds__``)
    assert QO._SHAPE[128]["threads"] * QO._SHAPE[128]["regs"] <= 65536


def test_smem_at_the_paths_shapes():
    """Shared memory as ``topk_tile::smem_bytes`` sums it: the int8 flat
    call and the throughput row each hold one CTA an SM."""
    assert QO.smem_bytes(128, 20, True) == 192004
    assert QO.smem_bytes(128, 20, False) == 194052
    assert QO.smem_bytes(64, 10, False) == 126724
    for tile, k, quant in ((128, 20, True), (64, 10, False)):
        assert QO.ctas_per_sm(tile, k, quant) == 1


@pytest.mark.parametrize("row_bytes,offset,want", [
    (512, 0, 16), (120, 0, 8), (132, 0, 4), (40, 0, 8), (36, 0, 4),
    (512, 4, 4), (512, 8, 8)])
def test_copy_width(row_bytes, offset, want):
    buf = torch.zeros(4096, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    assert QO.copy_width(row_bytes, buf[offset:]) == want


def test_copy_width_refuses_rows_of_odd_bytes():
    with pytest.raises(ValueError):
        QO.copy_width(30, torch.zeros(64, dtype=torch.int8))


def test_sweep_cuts_apply_to_the_kernel():
    """``chip_smoke.py --sweep`` times copies of the kernel with parts cut
    out; each cut still finds the text it replaces, and every cut but the
    shipped one lets no distance survive the filter."""
    import sys
    root = _build.KERNELS_DIR.parents[2]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(root))
    shipped = (_build.KERNELS_DIR / "csrc" / "topk_tile.cuh").read_text()
    assert cs.topk_cut("full") == shipped
    texts = {cut: cs.topk_cut(cut) for cut in cs.TOPK_CUTS if cut != "full"}
    assert len(set(texts.values())) == len(texts)
    for text in texts.values():
        assert "acc[r][c] < -1e30f" in text and text != shipped

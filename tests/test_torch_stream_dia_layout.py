"""The launch layout of kernel A (``csrc/stream_cg_dia.cu``), on the CPU.

Each block of a launch owns one tile of consecutive rows
(``stream_cg_dia.tile_rows``: n over the SM count, rounded up to 32 rows,
at least 512) and, where its window of the direction (the tile's rows and
``max|off|`` rows each side, every RHS and plane) fits the block's shared
memory beside the tap list, stages it there once an iteration
(``dia_layout``).  These tests hold the tiles to that rule at the Fig. 5
shapes and at sizes around its corners, hold the tiles to one an SM and to
the RHS count not moving them (a RHS's bits rest on it), and hold the
window's bytes and the staged-or-direct choice to the kernel's note.  The
card tests (tests/test_torch_cuda.py) hold the rule to the kernel's own
answer.
"""
import pytest

from tpcg_torch.ops import stream_cg_dia as tsd

H100_SMS = 132
M_T1 = (0,) + tuple(o for k in range(1, 51) for o in (37 * k, -37 * k))
HELM_FEM = (0, 1, -1, 128, -128, 129, -129)
PARABOLIC = (0, 1, -1, 725, -725, 726, -726)
BUDGET = tsd.SMEM_PER_BLOCK - tsd._STATIC_SMEM


@pytest.mark.parametrize("n,offsets,rows,tiles", [
    (97_578, M_T1, 768, 128),        # m_t1: 127 tiles of 768, one of 42
    (16_384, HELM_FEM, 512, 32),     # helm_fem: the parent's 32 blocks
    (525_625, PARABOLIC, 4000, 132),
    (1280, tuple(range(-8, 9)), 512, 3),
])
def test_tiles_at_the_fig5_shapes(n, offsets, rows, tiles):
    for nb in (1, 8):
        lay = tsd.dia_layout(n, offsets, nb, 1, H100_SMS)
        assert (lay.tile_rows, lay.tiles) == (rows, tiles)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("n", [1, 31, 512, 513, 67_584, 67_585, 97_578,
                               525_625, 2**31 - 3001])
def test_tiles_cover_the_rows_at_most_one_an_sm(n, sms):
    rows = tsd.tile_rows(n, sms)
    tiles = tsd.dia_layout(n, (0, 1, -1), 1, 1, sms).tiles
    assert rows % 32 == 0 and rows >= tsd.TILE_ROWS_MIN
    assert (tiles - 1) * rows < n <= tiles * rows
    assert tiles <= sms
    if rows > tsd.TILE_ROWS_MIN:
        # no smaller multiple of 32 keeps one tile an SM
        assert -(-n // (rows - 32)) > sms


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("n,offsets", [(97_578, M_T1), (16_384, HELM_FEM),
                                       (20_000, (0, 6000, -6000))])
def test_tiles_do_not_depend_on_the_rhs_count(n, offsets, planes):
    lays = [tsd.dia_layout(n, offsets, nb, planes, H100_SMS)
            for nb in range(1, 9)]
    assert len({(lay.tile_rows, lay.tiles) for lay in lays}) == 1


def test_window_bytes_and_the_staged_rule():
    ring = tsd.RING_BYTES
    assert ring == 4 * 8 * 2 * 384
    # m_t1 at 8 RHS: (768 + 2 * 1850 + 3) rows rounded up to 4, x 8 RHS x
    # 4 B, beside the rings and 101 taps
    lay = tsd.dia_layout(97_578, M_T1, 8, 1, H100_SMS)
    assert tsd.window_bytes(97_578, M_T1, 8, 1, H100_SMS) == 4472 * 32
    assert lay.staged and lay.smem == 143_104 + ring + 4 * 101
    assert tsd.dia_layout(97_578, M_T1, 1, 1, H100_SMS).smem == \
        17_888 + ring + 404
    # helm_fem, complex, 1 RHS: (512 + 258 + 3 -> 776) rows x 2 planes x 4 B
    assert tsd.dia_layout(16_384, HELM_FEM, 1, 2, H100_SMS).smem == \
        6208 + ring + 28
    # half-width 6000 at n = 20,000: 400 KB at 8 RHS reads from L2, 50 KB
    # at 1 RHS stages
    wide = (0, 6000, -6000)
    direct = tsd.dia_layout(20_000, wide, 8, 1, H100_SMS)
    assert not direct.staged and direct.smem == ring + 12
    assert tsd.dia_layout(20_000, wide, 1, 1, H100_SMS).staged


@pytest.mark.parametrize("planes,nb", [(1, 1), (1, 8), (2, 1), (2, 8)])
def test_staged_up_to_the_block_budget(planes, nb):
    """The widest band staged fills the budget to within a few rows; one row
    wider each side reads from L2."""
    n = 200_000
    per_row = 4 * planes * nb

    def staged(pad):
        return tsd.dia_layout(n, (0, pad, -pad), nb, planes, H100_SMS).staged
    lo, hi = 1, 200_000       # staged(lo), not staged(hi)
    assert staged(lo) and not staged(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if staged(mid) else (lo, mid)
    smem = tsd.dia_layout(n, (0, lo, -lo), nb, planes, H100_SMS).smem
    assert smem <= BUDGET < smem + 4 * per_row

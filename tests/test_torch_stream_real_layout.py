"""The padded layout of ``csrc/stream_cg_real.cu`` (``real_layout``), on the
CPU.

The kernel keeps r, both d buffers, a working copy of x (and q in coef
mode), and in coef mode a copy of the coefficient planes, in planes whose
row pitch is nh + pad rounded up to 32 floats, zero past column nh; it
applies the stencil to halo boxes that start ``col_halo`` columns left of a
tile and ``pad`` rows above it, and reads a coef tile's planes from boxes of
the tile alone.  These tests hold the geometry to that rule at widths that
are and are not multiples of 4, 32 and 128, hold the rings to an H100's
shared memory at every pad and tap count the kernel takes, in both modes,
hold the byte counts to the kernel's note, and hold the premise the kernel
rests on: the operator applied to planes zero-padded to the pitch, then
cropped, is the operator applied to the unpadded planes, bit for bit (a
neighbour or a coefficient past column nh - 1 reads the zero columns, as it
reads 0 outside the grid).
"""
import types

import numpy as np
import pytest
import torch

from tpcg_torch.ops import _build, _tiles
from tpcg_torch.ops import stream_cg_real as tsr
from tpcg_torch.sparse import Stencil2D
from tpcg_torch.trace import counters

WIDTHS = (1, 7, 127, 128, 129, 1000, 2049)

STENCILS = {
    # Poisson's 5-point stencil
    "5-point": ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)),
    # the parabolic_fem-class 7-point FE stencil
    "7-point": ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1),
                (-1, -1)),
    # a 9-tap stencil two nodes out, with far diagonals
    "9-point": ((0, 0), (0, 2), (0, -1), (2, 0), (-1, 0), (2, -2), (-2, 1),
                (1, 2), (-2, -2)),
}


def _pad_of(offsets):
    return max(max(abs(dm), abs(dj)) for dm, dj in offsets)


@pytest.mark.parametrize("coef", [False, True])
@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("nh", WIDTHS)
def test_pitch_is_aligned_and_copy_leaves_zero_columns(nh, pad, coef):
    """The pitch is a multiple of 32 floats (128 B) and at least nh + pad;
    a box's rows are 16-byte multiples and reach pad columns past the tile
    on each side and pad rows above and below it; the coefficient planes'
    copy at the pitch holds the planes and zeros past column nh."""
    offsets = STENCILS["5-point" if pad == 1 else "9-point"]
    lay = tsr.real_layout(37, nh, pad, len(offsets), coef)
    assert lay.pitch % 32 == 0 and lay.pitch >= nh + pad
    assert lay.pitch < nh + pad + 32
    assert lay.col_halo % 4 == 0 and lay.col_halo >= pad
    assert (lay.box_cols * 4) % 16 == 0
    assert lay.box_cols == lay.tile_cols + 2 * lay.col_halo
    assert lay.box_rows == lay.tile_rows + 2 * pad
    assert lay.tiles == -(-37 // lay.tile_rows) * -(-nh // lay.tile_cols)
    assert (lay.coef_stages >= 1) == coef
    c = torch.from_numpy(np.random.default_rng(nh).standard_normal(
        (len(offsets), 37, nh)).astype(np.float32)) + 1.0
    copies = counters().get("copy.pad_real_planes", 0)
    cp = tsr.pad_real_planes(offsets, c)
    assert counters().get("copy.pad_real_planes", 0) == copies + 1
    assert cp.shape == (len(offsets), 37, lay.pitch) and cp.is_contiguous()
    assert torch.equal(cp[..., :nh], c)
    assert torch.count_nonzero(cp[..., nh:]) == 0


@pytest.mark.parametrize("coef", [False, True])
@pytest.mark.parametrize("rows,pad,noff,want", [
    (16, 1, 5, 41.5625), (32, 1, 5, 41.03125), (8, 1, 5, 42.625),
    (4, 1, 5, 44.75), (16, 2, 9, 42.625), (16, 0, 1, 40.0)])
def test_bytes_a_node(rows, pad, noff, want, coef):
    """40 + 8 h bytes a node, h the halo's share of a box (the kernel's
    note: 41.6 B at R = 16, pad 1, h = 0.195), plus 4 B a tap in coef mode:
    phase A reads r and d_old with their halo and writes d' and q, 16 + 8 h
    (and reads the tile's noff planes, 4 noff); phase B reads x, d', r and q
    and writes x and r, 24."""
    lay = tsr.real_layout(4096, 4096, pad, noff, coef, tile_rows=rows,
                          stages=2, coef_stages=1)
    assert lay.tile_rows == rows and lay.tile_cols == 128
    h = lay.box_rows * lay.box_cols / (rows * lay.tile_cols) - 1
    taps = 4 * noff if coef else 0
    assert lay.bytes_a == pytest.approx(16 + 8 * h + taps)
    assert lay.bytes_b == pytest.approx(24.0)
    assert lay.bytes_a + lay.bytes_b == pytest.approx(want + taps)
    if (rows, pad) == (16, 1):
        assert h == pytest.approx(0.1953125)


@pytest.mark.parametrize("n", [1024, 2047, 2048, 2049, 4096])
def test_const_tiles_by_grid_size(n):
    """Const mode takes the smaller tiles and more blocks an SM below
    SMALL_GRID_NODES nodes (at N = 1024 a 16-row tile leaves the blocks
    uneven shares), the larger tiles from there; coef mode one tile at every
    size."""
    small = n * n < tsr.SMALL_GRID_NODES
    lay = tsr.real_layout(n, n, 1, 5, False)
    assert lay.tile_rows == (tsr.SMALL_TILE_ROWS if small else tsr.TILE_ROWS)
    assert lay.blocks_per_sm == (tsr.SMALL_BLOCKS_PER_SM if small
                                 else tsr.BLOCKS_PER_SM)
    assert tsr.real_layout(n, n, 1, 5, True).tile_rows == tsr.COEF_TILE_ROWS
    assert small == (n < 2048)


@pytest.mark.parametrize("coef", [False, True])
@pytest.mark.parametrize("noff", [1, 5, 7, 16])
@pytest.mark.parametrize("pad", range(9))
def test_rings_fit_their_blocks_at_every_pad(pad, noff, coef):
    """At every pad 0..8 and tap count up to 16, in both modes, the rings
    fit a block (227 KB with the static shared memory) and blocks_per_sm
    blocks fit one H100 SM's 228 KB (1 KB of it reserved a block): the
    layout drops a coefficient slot, then halves its tile's rows, rather
    than refuse a stencil the kernel takes; its boxes stay within TMA's 256
    a side."""
    lay = tsr.real_layout(4096, 4096, pad, noff, coef)
    assert lay.tile_rows >= 1 and lay.stages >= 2
    assert lay.coef_stages >= 1 if coef else lay.coef_stages == 0
    per = lay.smem_bytes + _tiles.STATIC_SHARED
    assert per <= _tiles.BLOCK_SHARED
    assert lay.blocks_per_sm >= 1
    assert (lay.blocks_per_sm * (per + _tiles.BLOCK_RESERVED)
            <= _tiles.SM_SHARED)
    assert max(lay.box_rows, lay.box_cols, noff) <= 256
    default = tsr.COEF_TILE_ROWS if coef else tsr.TILE_ROWS
    if lay.tile_rows < default:
        # narrowed only because the default tile does not fit
        assert (_tiles.STATIC_SHARED + tsr._ring_bytes(
            default, pad, lay.col_halo, noff, coef, lay.stages, 1)
            > _tiles.BLOCK_SHARED)


@pytest.mark.parametrize("rows,pad,noff,coef,want", [
    (16, 1, 5, False, 39424), (8, 1, 5, False, 22016),
    (4, 1, 5, True, 23552), (16, 8, 16, True, 204800),
    (16, 8, 16, False, 73728)])
def test_layout_matches_the_kernels_smem_formula(rows, pad, noff, coef, want):
    """smem_bytes is the kernel's formula: stages state slots of two halo
    boxes (phase A's r and d_old), and in coef mode coef_stages slots of the
    tile's noff planes; each box rounded up to 32 floats (128 B, TMA's
    alignment)."""
    hc = -(-pad // 4) * 4
    bc = 128 + 2 * hc
    box = -(-((rows + 2 * pad) * bc) // 32) * 32
    cbox = noff * rows * 128 if coef else 0
    assert tsr._ring_bytes(rows, pad, hc, noff, coef, 2, 1) \
        == 4 * (cbox + 2 * 2 * box) == want
    lay = tsr.real_layout(4096, 4096, pad, noff, coef, tile_rows=rows,
                          stages=2, coef_stages=1)
    if lay.tile_rows == rows:
        assert lay.smem_bytes == want


def _stencil(offsets, nv, nh, seed, coef):
    """A real stencil on the offsets: const taps (4 at the centre, the rest
    from -0.2, -0.15, -0.1, so that equal taps form groups), or in coef
    mode those times 1 + 0.3 U(0, 1).  Taps that leave the grid are zero
    where the stencil reaches one node (const mode's strips and edge taps
    then undo the interior taps there) or in coef mode; a wider const
    stencil keeps them (const mode allows one ring of deviation only)."""
    rng = np.random.default_rng(seed)
    vals = [4.0] + [(-0.2, -0.15, -0.1)[k % 3] for k in range(len(offsets) - 1)]
    cut = coef or _pad_of(offsets) == 1
    c = np.zeros((len(offsets), nv, nh))
    for s, (dm, dj) in enumerate(offsets):
        if cut:
            c[s, max(0, -dm):nv - max(0, dm),
              max(0, -dj):nh - max(0, dj)] = vals[s]
        else:
            c[s] = vals[s]
    if coef:
        c *= 1.0 + 0.3 * rng.random(c.shape)
    return Stencil2D(offsets, torch.from_numpy(c), (nv, nh))


@pytest.mark.parametrize("nv,nh", [(37, 45), (33, 129)])
@pytest.mark.parametrize("name", sorted(STENCILS))
@pytest.mark.parametrize("coef", [False, True])
def test_apply_on_padded_rows_equals_unpadded(coef, name, nv, nh):
    """apply_const_real and apply_coef_real on x (and coef mode's planes)
    zero-padded to the pitch, cropped to nh, equal them on the unpadded
    planes bit for bit, at odd heights and widths, for the 5-, 7- and 9-tap
    stencils; the padded columns of q stay zero.  Rows 0 and nv - 1 and
    columns 0 and nh - 1 are checked on their own: there the taps reach the
    zero border (and in const mode the strips and edge taps apply)."""
    offsets = STENCILS[name]
    S = _stencil(offsets, nv, nh, nv * nh + len(offsets), coef)
    mode, operand = tsr.prepare_real(S)
    assert mode == ("coef" if coef else "const")
    lay = tsr.real_layout(nv, nh, _pad_of(offsets), len(offsets), coef)
    rng = np.random.default_rng(nv + nh)
    xp = torch.from_numpy(rng.standard_normal((nv, nh)).astype(np.float32))
    xpad = tsr.pad_rows(xp, lay.pitch)
    if coef:
        q_pad = tsr.apply_coef_real(offsets, tsr.pad_real_planes(
            offsets, operand), xpad)
        q = tsr.apply_coef_real(offsets, operand, xp)
    else:
        taps, strips = operand
        q_pad = tsr.apply_const_real(offsets, taps, strips, xpad)
        q = tsr.apply_const_real(offsets, taps, strips, xp)
    assert q_pad.shape == (nv, lay.pitch)
    assert torch.count_nonzero(q_pad[:, nh:]) == 0
    assert torch.equal(q_pad[:, :nh], q)
    assert torch.equal(q_pad[0, :nh], q[0])
    assert torch.equal(q_pad[nv - 1, :nh], q[nv - 1])
    assert torch.equal(q_pad[:, 0], q[:, 0])
    assert torch.equal(q_pad[:, nh - 1], q[:, nh - 1])


# const mode's streaming layouts at pad 1 with 5 taps, field for field, as
# they were before the resident mode (and coef mode's, which has none)
STREAMING = {
    (2048, False): (2080, 16, 128, 4, 18, 136, 2, 0, 3, 2048, 39424, 17.5625,
                    24.0, False),
    (4096, False): (4128, 16, 128, 4, 18, 136, 2, 0, 3, 8192, 39424, 17.5625,
                    24.0, False),
    (725, True): (736, 4, 128, 4, 6, 136, 2, 2, 2, 1092, 33792, 40.75, 24.0,
                  False),
    (2048, True): (2080, 4, 128, 4, 6, 136, 2, 2, 2, 8192, 33792, 40.75, 24.0,
                   False),
    (4096, True): (4128, 4, 128, 4, 6, 136, 2, 2, 2, 32768, 33792, 40.75,
                   24.0, False),
}


# the kernel's resident limits (kResidentRows, kResidentMinBlocks), which
# tests/test_torch_cuda.py reads from the built library
RESIDENT = (12, 3)


def _on_card(monkeypatch, sms=132):
    """``card_layout``'s layout on a card of ``sms`` SMs, without one: the
    library's limits (``RESIDENT`` for resident mode) and a grid query whose
    occupancy is the blocks an SM the layout asks for, as an H100's is."""
    def query(entry, *args):
        if entry == "tpcg_stream_real_limits":
            return (16, 8) + RESIDENT
        nv, nh, resident, rows, per_sm = (args[0], args[1], args[6],
                                          args[7], args[11])
        tiles = -(-nv // rows) * -(-nh // tsr.TILE_COLS)
        held = sms * per_sm
        return (tiles if tiles <= held else 0 if resident else held,)
    monkeypatch.setattr(_build, "query", query)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    return lambda *args: tsr.card_layout(*args)[0]


@pytest.mark.parametrize("n,coef", sorted(STREAMING))
def test_streaming_layout_unchanged_where_no_wave_holds_the_grid(
        monkeypatch, n, coef):
    """At 2048^2 and 4096^2 const mode has more tiles of the resident mode's
    12 rows than an H100's 132 SMs hold blocks, and coef mode has no
    resident mode: the launch's layout is the streaming one, field for
    field."""
    lay = _on_card(monkeypatch)(n, n, 1, 5, coef)
    assert tuple(lay) == STREAMING[n, coef]
    assert lay == tsr.real_layout(n, n, 1, 5, coef)


@pytest.mark.parametrize("n,rows", [(725, 11), (8, 1), (511, 6)])
def test_resident_layout_at_grids_one_wave_holds(monkeypatch, n, rows):
    """Below the resident limit (at 132 SMs, 3 blocks an SM: 396 blocks)
    const mode takes one tile a block: the fewest tile rows whose tiles
    number at most 396 (725^2: 11 rows, 66 x 6 = 396 tiles, where the
    streaming layout's 546 tiles of 8 rows left 18 of its 528 blocks two
    tiles), at most 12; its bytes a node: r and d_old with their halo and
    d' in phase A, r in phase B."""
    lay = _on_card(monkeypatch)(n, n, 1, 7, False)
    assert lay.resident and lay.tile_rows == rows
    assert lay.blocks_per_sm == RESIDENT[1] == 3
    assert lay.tiles == -(-n // rows) * -(-n // 128) <= 396
    if rows > 1:
        assert -(-n // (rows - 1)) * -(-n // 128) > 396
    assert lay.smem_bytes == tsr._ring_bytes(rows, 1, 4, 7, False, 2, 0)
    h = lay.box_rows * lay.box_cols / (rows * lay.tile_cols) - 1
    assert lay.bytes_a == pytest.approx(8 * (1 + h) + 4)
    assert lay.bytes_b == 4.0
    stream = tsr.real_layout(n, n, 1, 7, False)
    assert (lay.pitch, lay.col_halo, lay.box_rows, lay.box_cols) == (
        stream.pitch, 4, rows + 2, 136)


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132])
@pytest.mark.parametrize("pad", [0, 1, 2, 8])
def test_resident_tiles_never_pass_the_co_resident_blocks(monkeypatch, sms,
                                                          pad):
    """Wherever the launch takes the resident layout, its tiles number at
    most the blocks the card holds at once (SMs times the kernel's blocks
    an SM), those blocks fit an SM's shared memory, and its tiles are at
    most the kernel's 12 rows; no fewer rows would do.  Elsewhere the
    layout is the streaming one."""
    layout = _on_card(monkeypatch, sms)
    noff = 16 if pad == 8 else 5
    for nv in (1, 7, 100, 512, 725, 1000, 1031, 2048):
        for nh in (1, 129, 725, 1100, 2049):
            lay = layout(nv, nh, pad, noff, False)
            if not lay.resident:
                assert lay == tsr.real_layout(nv, nh, pad, noff, False)
                continue
            assert lay == tsr.resident_layout(nv, nh, pad, noff, sms,
                                              *RESIDENT)
            assert lay.tiles <= sms * lay.blocks_per_sm
            assert lay.blocks_per_sm == RESIDENT[1]
            per = lay.smem_bytes + _tiles.STATIC_SHARED
            assert lay.blocks_per_sm * (per + _tiles.BLOCK_RESERVED) \
                <= _tiles.SM_SHARED
            assert lay.tile_rows <= RESIDENT[0]
            if lay.tile_rows > 1:
                fewer = -(-nv // (lay.tile_rows - 1)) * -(-nh // 128)
                assert fewer > sms * lay.blocks_per_sm


@pytest.mark.parametrize("n,sms", [(1024, 132), (2048, 132), (725, 16)])
def test_streaming_where_the_rows_pass_the_register_budget(monkeypatch, n,
                                                           sms):
    """Where the fewest rows that fit the card's blocks pass the kernel's 12
    (it keeps x, r and q of 6 nodes a thread in registers), the launch
    keeps the streaming layout: 1024^2 (21 rows) and 2048^2 at 132 SMs,
    725^2 on a card of 16."""
    assert tsr.resident_rows(n, n, RESIDENT[1] * sms, RESIDENT[0]) is None
    lay = _on_card(monkeypatch, sms)(n, n, 1, 7, False)
    assert lay == tsr.real_layout(n, n, 1, 7, False) and not lay.resident


def test_register_budget_decides_the_fallback():
    """725^2 needs 11-row tiles at 132 SMs: with a budget of 10 rows the
    rule finds no resident layout, with 11 it finds one of 11 rows."""
    assert tsr.resident_layout(725, 725, 1, 7, 132, 10, 3) is None
    assert tsr.resident_layout(725, 725, 1, 7, 132, 11, 3).tile_rows == 11


@pytest.mark.parametrize("per_sm", [3, 6, 12])
def test_resident_layout_needs_its_blocks_an_sm(per_sm):
    """The resident layout asks an SM to hold the kernel's blocks an SM at
    once: where an SM's shared memory holds fewer rings of its tiles, there
    is none (at 725^2 and pad 8, on 396 / per_sm SMs, rings of 11 rows: 3
    an SM, not 6 or 12)."""
    sms = 396 // per_sm
    assert tsr.resident_rows(725, 725, sms * per_sm, 12) == 11
    lay = tsr.resident_layout(725, 725, 8, 16, sms, 12, per_sm)
    if per_sm == 3:
        assert lay.blocks_per_sm == 3 and lay.tile_rows == 11
    else:
        assert lay is None

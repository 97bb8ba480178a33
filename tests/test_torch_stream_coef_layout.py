"""The padded layout of ``csrc/stream_cg_coef.cu`` (``coef_layout``), on the
CPU.

The kernel keeps r, both d buffers, q and a working copy of x, and a copy of
the coefficient planes, in planes whose row pitch is nh + pad rounded up to
32 floats, zero past column nh; it applies the stencil to halo boxes that
start ``col_halo`` columns left of a tile, and keeps one RHS's boxes a state
slot and a tile's coefficient planes a coefficient slot, so that its shared
memory does not grow with the RHS count.  These tests hold the geometry to
that rule at widths that are and are not multiples of 4, 32 and 128, hold
the rings to an H100's shared memory at every pad and RHS count the kernel
takes, and hold the premise the kernel rests on: the operator applied to
planes zero-padded to the pitch, then cropped, is the operator applied to
the unpadded planes, bit for bit (the neighbours past column nh-1 read the
zero columns, as they read 0 outside the grid).
"""
import numpy as np
import pytest
import torch

from tpcg_torch.ops import _tiles
from tpcg_torch.ops import stream_cg_coef as tgc
from tpcg_torch.sparse import Stencil2D

WIDTHS = (1, 7, 127, 128, 129, 1000, 2049)

OFFSETS = {
    5: ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)),
    7: ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, -1), (-1, 1)),
    9: tuple((dm, dj) for dm in (0, 1, -1) for dj in (0, 1, -1)),
    13: ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2), (2, 0),
         (-2, 0), (1, 1), (-1, -1), (2, 1), (-1, 2)),
}


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("nh", WIDTHS)
def test_pitch_is_aligned_and_leaves_pad_zero_columns(nh, pad):
    """The pitch is a multiple of 32 floats (128 B) and at least nh + pad; a
    halo box's rows are 16-byte multiples and reach pad columns past the
    tile on each side; the coefficient copy at the pitch holds the planes
    and zeros past column nh."""
    lay = tgc.coef_layout(37, nh, pad, 1)
    assert lay.pitch % 32 == 0 and lay.pitch >= nh + pad
    assert lay.pitch < nh + pad + 32
    assert lay.col_halo % 4 == 0 and lay.col_halo >= pad
    assert (lay.box_cols * 4) % 16 == 0
    assert lay.box_cols == tgc.TILE_COLS + 2 * lay.col_halo
    assert lay.box_rows == lay.tile_rows + 2 * pad
    assert lay.tiles == -(-37 // lay.tile_rows) * -(-nh // tgc.TILE_COLS)
    c = torch.from_numpy(np.random.default_rng(nh).standard_normal(
        (2, 3, 37, nh)).astype(np.float32)) + 1.0
    cp = tgc.pad_rows(c, lay.pitch)
    assert cp.shape == (2, 3, 37, lay.pitch)
    assert torch.equal(cp[..., :nh], c)
    assert torch.count_nonzero(cp[..., nh:]) == 0


@pytest.mark.parametrize("rows,pad,noff,nb,want", [
    (4, 1, 7, 1, 145.5), (4, 1, 7, 8, 96.5), (8, 1, 9, 2, 121.25),
    (8, 1, 7, 1, 141.25), (16, 1, 7, 1, 139.125), (8, 2, 13, 4, 115.5)])
def test_bytes_a_node(rows, pad, noff, nb, want):
    """80 + 16 h + 8 noff / NB bytes a node and RHS, h the halo's share of a
    box (the kernel's comment: 145.5 B at R = 4, pad 1, noff = 7, NB = 1):
    phase A 16 (1 + h) + 16 + 8 noff / NB, phase B 48."""
    lay = tgc.coef_layout(4096, 4096, pad, nb, noff, tile_rows=rows,
                          stages=2, coef_stages=1)
    assert lay.tile_rows == rows
    share = lay.box_rows * lay.box_cols / (rows * tgc.TILE_COLS)
    assert lay.bytes_a == pytest.approx(16 * share + 16 + 8 * noff / nb)
    assert lay.bytes_b == pytest.approx(48.0)
    assert lay.bytes_a + lay.bytes_b == pytest.approx(want)


@pytest.mark.parametrize("pad", range(9))
def test_ring_fits_its_blocks_an_sm_at_every_pad_and_rhs_count(pad):
    """For every RHS count 1..8 and every offset count a stencil of this
    reach can have (at most 32), the rings fit a block (227 KB with the
    static shared memory) and blocks_per_sm blocks fit one H100 SM's
    228 KB (1 KB of it reserved a block); the tile keeps two rows at least."""
    most = min(tgc.MAX_OFF, (2 * pad + 1) ** 2)
    for noff in sorted({1, min(7, most), min(13, most), most}):
        for nb in range(1, 9):
            lay = tgc.coef_layout(4096, 4096, pad, nb, noff)
            assert lay.tile_rows >= 2 and lay.stages >= 2
            per = lay.smem_bytes + _tiles.STATIC_SHARED
            assert per <= _tiles.BLOCK_SHARED
            assert lay.blocks_per_sm >= 1
            assert lay.blocks_per_sm * (per + _tiles.BLOCK_RESERVED) \
                <= _tiles.SM_SHARED


@pytest.mark.parametrize("pad", range(9))
def test_layout_keeps_8_rhs_a_launch_and_one_tile_for_every_nb(pad):
    """A launch takes 8 RHS at every pad (helm_fe_var's pad 1 and the
    13-point stencil's pad 2 among them), and the tile, the rings and so
    the grid do not depend on the RHS count: the premise of each RHS of an
    NB launch giving its NB = 1 launch's bits."""
    noff = min(tgc.MAX_OFF, (2 * pad + 1) ** 2)
    lays = [tgc.coef_layout(2049, 1027, pad, nb, noff) for nb in range(1, 9)]
    assert all(lay.rhs_per_launch == 8 for lay in lays)
    assert len({lay._replace(bytes_a=0.0) for lay in lays}) == 1


def test_layout_matches_the_kernels_smem_formula():
    """smem_bytes is the kernel's formula: coef_stages slots of 2 noff tile
    planes, stages slots of two halo boxes, each box both planes rounded up
    to 32 floats (128 B, TMA's alignment)."""
    lay = tgc.coef_layout(4096, 4096, 1, 1, 7, tile_rows=8, stages=2,
                          coef_stages=1)
    box = -(-(2 * 10 * 136) // 32) * 32
    assert lay.smem_bytes == 4 * (2 * 7 * 8 * 128 + 2 * 2 * box)
    assert lay.smem_bytes == 100864


def _stencil(noff, nv, nh, seed):
    """A non-symmetric stencil of the given offsets with random complex
    coefficients on every node."""
    rng = np.random.default_rng(seed)
    offsets = OFFSETS[noff]
    c = rng.standard_normal((noff, nv, nh)) \
        + 1j * rng.standard_normal((noff, nv, nh))
    return Stencil2D(offsets, torch.from_numpy(c), (nv, nh))


@pytest.mark.parametrize("nv,nh", [(37, 45), (33, 129)])
@pytest.mark.parametrize("noff", [5, 7, 9, 13])
def test_apply_on_padded_rows_equals_unpadded(noff, nv, nh):
    """apply_coef_planes on x and the coefficient planes zero-padded to the
    pitch, cropped to nh, equals it on the unpadded planes bit for bit; at
    an odd height and an odd width, for the 5-, 7-, 9- and 13-point
    stencils."""
    S = _stencil(noff, nv, nh, noff * nv)
    coefp = tgc.prepare_stream_coef(S)
    pad = max(max(abs(dm), abs(dj)) for dm, dj in S.offsets)
    lay = tgc.coef_layout(nv, nh, pad, 1, noff)
    rng = np.random.default_rng(nv * nh)
    xp = torch.from_numpy(rng.standard_normal((2, nv, nh)).astype(np.float32))
    q_pad = tgc.apply_coef_planes(S.offsets, tgc.pad_rows(coefp, lay.pitch),
                                  tgc.pad_rows(xp, lay.pitch))
    q = tgc.apply_coef_planes(S.offsets, coefp, xp)
    assert torch.equal(q_pad[..., :nh], q)
    assert torch.count_nonzero(q_pad[..., nh:]) == 0

"""The padded state layout of ``csrc/stream_cg.cu`` (``stream_layout``), on
the CPU.

The kernel keeps r, both d buffers and a working copy of x in planes whose
row pitch is nh + pad rounded up to 32 floats, zero past column nh, and
applies the stencil to halo boxes that start ``col_halo`` columns left of a
tile.  These tests hold the geometry to that rule at widths that are and are
not multiples of 4, 32 and 128, and hold the premise the kernel rests on:
the operator applied to planes zero-padded to the pitch, then cropped, is
the operator applied to the unpadded planes, bit for bit (the neighbours
past column nh-1 read the zero columns, as they read 0 outside the grid).
"""
import numpy as np
import pytest
import torch

from tpcg_torch.ops import stream_cg as ts
from tpcg_torch.problems import local_rect
from tpcg_torch.sparse import Stencil2D

WIDTHS = (1, 7, 127, 128, 129, 1000, 2049)

PAD2_OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2),
                (2, 0), (-2, 0), (1, 1), (-1, -1), (2, 1), (-1, 2))


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("nh", WIDTHS)
def test_pitch_is_aligned_and_leaves_pad_zero_columns(nh, pad):
    """The pitch is a multiple of 32 floats (128 B) and at least nh + pad;
    a halo box's rows are 16-byte multiples and reach pad columns past the
    tile on each side."""
    lay = ts.stream_layout(37, nh, pad)
    assert lay.pitch % 32 == 0 and lay.pitch >= nh + pad
    assert lay.pitch < nh + pad + 32
    assert lay.col_halo % 4 == 0 and lay.col_halo >= pad
    assert (lay.box_cols * 4) % 16 == 0
    assert lay.box_cols == ts.TILE_COLS + 2 * lay.col_halo
    assert lay.box_rows == lay.tile_rows + 2 * pad
    assert lay.tiles == -(-37 // lay.tile_rows) * -(-nh // ts.TILE_COLS)


@pytest.mark.parametrize("rows,pad,want", [(16, 1, 68.6875), (32, 1, 67.09375),
                                           (16, 2, 71.875)])
def test_bytes_a_node(rows, pad, want):
    """64 + 24 h bytes a node and RHS, h the halo's share of a box: phase A
    16 (1 + h) + 8, phase B 8 (1 + h) + 32."""
    lay = ts.stream_layout(4096, 4096, pad, tile_rows=rows)
    share = lay.box_rows * lay.box_cols / (rows * ts.TILE_COLS)
    assert lay.bytes_a == pytest.approx(16 * share + 8)
    assert lay.bytes_b == pytest.approx(8 * share + 32)
    assert lay.bytes_a + lay.bytes_b == pytest.approx(want)


def test_default_ring_fits_its_blocks_an_sm():
    """The default tile and ring fit BLOCKS_PER_SM blocks in one H100 SM's
    228 KB of shared memory (1 KB of it reserved a block) for stencils up to
    two nodes out, and one block (at most 227 KB) up to pad 8, where the
    kernel's occupancy query gives fewer blocks an SM."""
    for pad in range(9):
        lay = ts.stream_layout(4096, 4096, pad)
        assert lay.stages >= 2 and lay.smem_bytes <= 232448
        if pad <= 2:
            assert lay.blocks_per_sm * (lay.smem_bytes + 1024) <= 233472


def _pad2_stencil(nv, nh):
    """A 13-point stencil two nodes out with constant taps."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(len(PAD2_OFFSETS)) \
        + 1j * rng.standard_normal(len(PAD2_OFFSETS))
    coef = torch.from_numpy(np.broadcast_to(
        vals[:, None, None], (len(PAD2_OFFSETS), nv, nh)).copy())
    return Stencil2D(PAD2_OFFSETS, coef, (nv, nh))


def _stencil(kind, nv, nh):
    if kind == "pad2":
        return _pad2_stencil(nv, nh)
    S = local_rect(max(nv, nh), 9.0, 9.0, eta=9.0, Nvert=nv, Nhoriz=nh,
                   device="cpu")
    if kind == "5pt":
        return Stencil2D(S.offsets[:5], S.coef[:5].clone(), S.grid)
    return S


@pytest.mark.parametrize("nv,nh", [(37, 45), (33, 129)])
@pytest.mark.parametrize("kind", ["5pt", "7pt", "pad2"])
def test_apply_on_padded_rows_equals_unpadded(kind, nv, nh):
    """apply_const_planes on x zero-padded to the pitch (its strips zero past
    nh, the right edge taps, which act on column nh-1 alone, left out on
    both sides), cropped to nh, equals it on the unpadded x bit for bit; at
    an odd height and an odd width."""
    S = _stencil(kind, nv, nh)
    taps, strips = ts.prepare_stream(S)
    pad = max(max(abs(dm), abs(dj)) for dm, dj in S.offsets)
    lay = ts.stream_layout(nv, nh, pad)
    no_right = taps[:4] + (tuple(0.0 for _ in taps[4]),) * 2
    rng = np.random.default_rng(nv * nh)
    xp = torch.from_numpy(rng.standard_normal((2, nv, nh)).astype(np.float32))
    wide = lay.pitch - nh
    q_pad = ts.apply_const_planes(
        S.offsets, no_right, torch.nn.functional.pad(strips, (0, wide)),
        torch.nn.functional.pad(xp, (0, wide)))
    q = ts.apply_const_planes(S.offsets, no_right, strips, xp)
    assert torch.equal(q_pad[..., :nh], q)
    # the full operator differs from that only on column nh-1
    full = ts.apply_const_planes(S.offsets, taps, strips, xp)
    assert torch.equal(full[..., :nh - 1], q[..., :nh - 1])

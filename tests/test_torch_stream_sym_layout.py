"""The padded layout of ``csrc/stream_cg_sym.cu`` (``sym_layout``), on the
CPU.

The kernel keeps r, both d buffers, q and a working copy of x, and a copy of
the half coefficient planes, in planes whose row pitch is nh + pad rounded
up to 32 floats, zero past column nh; it applies the stencil to state halo
boxes that start ``col_halo`` columns left of a tile and ``pad`` rows above
it, and reads the half planes from boxes of the same columns that start
``pad`` rows above the tile, so that the mirrored term c_s(n - s) of every
node is in the box.  These tests hold the geometry to that rule at widths
that are and are not multiples of 4, 32 and 128, hold the rings to an
H100's shared memory at every pad and half-plane count the kernel takes,
and hold the premise the kernel rests on: the operator applied to planes
zero-padded to the pitch, then cropped, is the operator applied to the
unpadded planes, bit for bit (a neighbour or a coefficient past column
nh - 1 reads the zero columns, as it reads 0 outside the grid).
"""
import numpy as np
import pytest
import torch

from tpcg_torch.ops import _tiles
from tpcg_torch.ops import stream_cg as tsc
from tpcg_torch.ops import stream_cg_sym as tss
from tpcg_torch.sparse import Stencil2D
from tpcg_torch.trace import counters

WIDTHS = (1, 7, 127, 128, 129, 1000, 2049)

# half offsets: (0, 0) first, then offsets greater than (0, 0)
HALVES = {
    # helm_fe_var's 7-point stencil
    "7-point": ((0, 0), (0, 1), (1, -1), (1, 0)),
    # the 9-point square, reach 1
    "9-point": ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1)),
    # a 13-point stencil two nodes out, with a far diagonal
    "13-point": ((0, 0), (0, 1), (0, 2), (1, 0), (2, 0), (1, -2),
                 (2, 1)),
}


def _pad_of(half):
    return max(max(abs(dm), abs(dj)) for dm, dj in half)


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("nh", WIDTHS)
def test_pitch_is_aligned_and_copy_leaves_zero_columns(nh, pad):
    """The pitch is a multiple of 32 floats (128 B) and at least nh + pad;
    a box's rows are 16-byte multiples and reach pad columns past the tile
    on each side; the coefficient box starts pad rows above the tile; the
    half planes' copy at the pitch holds the planes and zeros past column
    nh."""
    half = HALVES["7-point" if pad == 1 else "13-point"]
    lay = tss.sym_layout(37, nh, pad, len(half))
    assert lay.pitch % 32 == 0 and lay.pitch >= nh + pad
    assert lay.pitch < nh + pad + 32
    assert lay.col_halo % 4 == 0 and lay.col_halo >= pad
    assert (lay.box_cols * 4) % 16 == 0
    assert lay.box_cols == lay.tile_cols + 2 * lay.col_halo
    assert lay.box_rows == lay.tile_rows + 2 * pad
    assert lay.coef_rows == lay.tile_rows + pad
    assert lay.tiles == -(-37 // lay.tile_rows) * -(-nh // lay.tile_cols)
    c = torch.from_numpy(np.random.default_rng(nh).standard_normal(
        (2, len(half), 37, nh)).astype(np.float32)) + 1.0
    copies = counters().get("copy.pad_sym_planes", 0)
    cp = tss.pad_sym_planes(half, c)
    assert counters().get("copy.pad_sym_planes", 0) == copies + 1
    assert cp.shape == (2, len(half), 37, lay.pitch) and cp.is_contiguous()
    assert torch.equal(cp[..., :nh], c)
    assert torch.count_nonzero(cp[..., nh:]) == 0


@pytest.mark.parametrize("rows,pad,nh1,want", [
    (8, 1, 4, 115.5), (4, 1, 4, 124.0), (16, 1, 4, 111.25),
    (8, 2, 7, 155.875), (2, 1, 5, 153.75), (8, 0, 1, 80.0)])
def test_bytes_a_node(rows, pad, nh1, want):
    """16 (1 + h_s) + 32 + 8 nh1 (1 + h_c) + 24 bytes a node, h_s and h_c
    the halo's shares of a state and a coefficient box (the kernel's
    comment: 115.5 B at R = 8, pad 1, nh1 = 4, h_s = 0.328, h_c = 0.195):
    phase A 16 (1 + h_s) + 32 + 8 nh1 (1 + h_c) (x read and written there,
    JAX's qx), phase B 24."""
    lay = tss.sym_layout(4096, 4096, pad, nh1, tile_rows=rows, stages=2,
                         coef_stages=1)
    assert lay.tile_rows == rows and lay.tile_cols == 128
    tile = rows * lay.tile_cols
    h_s = lay.box_rows * lay.box_cols / tile - 1
    h_c = lay.coef_rows * lay.box_cols / tile - 1
    assert lay.bytes_a == pytest.approx(16 * (1 + h_s) + 32
                                        + 8 * nh1 * (1 + h_c))
    assert lay.bytes_b == pytest.approx(24.0)
    assert lay.bytes_a + lay.bytes_b == pytest.approx(want)
    if (rows, pad, nh1) == (8, 1, 4):
        assert (h_s, h_c) == (pytest.approx(0.328125),
                              pytest.approx(0.1953125))


@pytest.mark.parametrize("nh1", [1, 4, 8, 16])
@pytest.mark.parametrize("pad", range(9))
def test_rings_fit_their_blocks_at_every_pad(pad, nh1):
    """At every pad 0..8 and half-plane count up to 16, the rings fit a
    block (227 KB with the static shared memory) and blocks_per_sm blocks
    fit one H100 SM's 228 KB (1 KB of it reserved a block): the layout
    narrows its tile (fewer rows, then 64 columns) rather than refuse a
    stencil the kernel takes; its boxes stay within TMA's 256 a side."""
    lay = tss.sym_layout(4096, 4096, pad, nh1)
    assert lay.tile_rows >= 1 and lay.stages >= 2 and lay.coef_stages >= 1
    assert lay.tile_cols in (64, 128)
    per = lay.smem_bytes + _tiles.STATIC_SHARED
    assert per <= _tiles.BLOCK_SHARED
    assert lay.blocks_per_sm >= 1
    assert (lay.blocks_per_sm * (per + _tiles.BLOCK_RESERVED)
            <= _tiles.SM_SHARED)
    assert max(lay.box_rows, lay.box_cols, 2 * nh1) <= 256
    if lay.tile_cols == 64 or lay.tile_rows < tss.TILE_ROWS:
        # narrowed only because the default tile does not fit
        assert (_tiles.STATIC_SHARED + tss._ring_bytes(
            tss.TILE_ROWS, 128, pad, lay.col_halo, nh1, lay.stages, 1)
            > _tiles.BLOCK_SHARED)


def test_layout_narrows_to_64_columns_at_the_limits():
    """nh1 = 16 at pad 8 (the kernel's limits): a 128-column tile's
    coefficient box alone takes 166 KB at one row, so the tile narrows to
    64 columns."""
    lay = tss.sym_layout(4096, 4096, 8, 16)
    assert lay.tile_cols == 64 and lay.box_cols == 80
    assert 2 * 16 * 9 * 144 * 4 == 165888


def test_layout_narrows_to_64_columns_before_one_row():
    """The order of the shrink steps: at pad 7 with 16 half planes the
    tile takes 2 rows of 64 columns, though 1 row of 128 would fit too."""
    lay = tss.sym_layout(4096, 4096, 7, 16)
    assert (lay.tile_rows, lay.tile_cols) == (2, 64)
    assert (_tiles.STATIC_SHARED + tss._ring_bytes(
        1, 128, 7, lay.col_halo, 16, lay.stages, 1) <= _tiles.BLOCK_SHARED)


@pytest.mark.parametrize("rows,pad,nh1,cols,want", [
    (8, 1, 4, 128, 82688), (4, 1, 4, 128, 47872), (2, 8, 16, 64, 148480)])
def test_layout_matches_the_kernels_smem_formula(rows, pad, nh1, cols, want):
    """smem_bytes is the kernel's formula: coef_stages slots of rows + pad
    box rows of 2 nh1 planes, stages slots of two state boxes (both
    planes), each box rounded up to 32 floats (128 B, TMA's alignment)."""
    hc = -(-pad // 4) * 4
    bc = cols + 2 * hc
    box = -(-(2 * (rows + 2 * pad) * bc) // 32) * 32
    cbox = -(-((rows + pad) * 2 * nh1 * bc) // 32) * 32
    assert tss._ring_bytes(rows, cols, pad, hc, nh1, 2, 1) \
        == 4 * (cbox + 2 * 2 * box) == want
    lay = tss.sym_layout(4096, 4096, pad, nh1, tile_rows=rows, stages=2,
                         coef_stages=1)
    if lay.tile_cols == cols and lay.tile_rows == rows:
        assert lay.smem_bytes == want


def _sym_stencil(half, nv, nh, seed):
    """A symmetric stencil on the given half offsets: random complex half
    planes, each mirrored plane plane_{-s}(n) = plane_s(n - s)."""
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.standard_normal((len(half), nv, nh))
                         + 1j * rng.standard_normal((len(half), nv, nh)))
    mirrors = [tss._shift(c[t], dm, dj) for t, (dm, dj) in enumerate(half)
               if t > 0]
    offsets = tuple(half) + tuple((-dm, -dj) for dm, dj in half[1:])
    return Stencil2D(offsets, torch.cat([c, torch.stack(mirrors)]),
                     (nv, nh))


@pytest.mark.parametrize("nv,nh", [(37, 45), (33, 129)])
@pytest.mark.parametrize("name", sorted(HALVES))
def test_apply_on_padded_rows_equals_unpadded(name, nv, nh):
    """apply_sym_planes on x and the half planes zero-padded to the pitch,
    cropped to nh, equals it on the unpadded planes bit for bit, at odd
    heights and widths, for the 7-, 9- and 13-point stencils: the mirrored
    terms at row 0 and column 0 read the zero border, the down terms at
    column nh - 1 the zero columns."""
    half = HALVES[name]
    S = _sym_stencil(half, nv, nh, nv * nh + len(half))
    half_s, cplanes = tss.prepare_stream_sym(S)
    assert tuple(half_s) == half
    lay = tss.sym_layout(nv, nh, _pad_of(half), len(half))
    rng = np.random.default_rng(nv + nh)
    xp = torch.from_numpy(rng.standard_normal((2, nv, nh)).astype(np.float32))
    q_pad = tss.apply_sym_planes(half, tss.pad_sym_planes(half, cplanes),
                                 tss.pad_rows(xp, lay.pitch))
    q = tss.apply_sym_planes(half, cplanes, xp)
    assert torch.equal(q_pad[..., :nh], q)
    # the mirrored terms reach the edges: row 0 and column 0 are not the
    # down terms alone
    down = torch.zeros_like(q)
    for t, (dm, dj) in enumerate(half):
        shifted = torch.stack([tss._shift(xp[k], -dm, -dj) for k in (0, 1)])
        cr, ci = cplanes[0, t], cplanes[1, t]
        down = down + torch.stack([cr * shifted[0] - ci * shifted[1],
                                   cr * shifted[1] + ci * shifted[0]])
    assert not torch.allclose(q[:, 0, :], down[:, 0, :])
    assert not torch.allclose(q[:, :, 0], down[:, :, 0])


def _deferred_x_cocg(half, cplanes, bp, x0p, n_iterations):
    """stream_cg_sym_planes_plain's iteration with the kernel's order of the
    x update (JAX's qx): x += alpha d' of iteration k runs at the start of
    iteration k + 1, before d' is formed anew, and once after the last
    iteration; every other step as the plain version."""
    def udot(a, b):
        return tsc._udot_grid(a.double(), b.double()).float()

    def rr(r):
        return tsc._rr_grid(r.double()).float()

    def apply(v):
        return tss.apply_sym_planes(half, cplanes, v)
    x = x0p.clone()
    r = bp - apply(x0p)
    d = torch.zeros_like(bp)
    delta = rr(r)
    hist = [tsc._hist_row(delta)]
    beta = torch.zeros_like(delta)
    zero = torch.zeros_like(delta[0])
    pending = None
    for _ in range(n_iterations):
        if pending is not None:
            a_r, a_i, dp = pending
            x = torch.stack([x[0] + a_r * dp[0] - a_i * dp[1],
                             x[1] + a_r * dp[1] + a_i * dp[0]])
        d = torch.stack([r[0] + beta[0] * d[0] - beta[1] * d[1],
                         r[1] + beta[0] * d[1] + beta[1] * d[0]])
        q = apply(d)
        dq = udot(d, q)
        done = ((delta[0] == 0) & (delta[1] == 0)) \
            | ((dq[0] == 0) & (dq[1] == 0))
        a_r, a_i = tsc._cdiv(delta[0], delta[1],
                             torch.where(done, 1.0, dq[0]),
                             torch.where(done, 0.0, dq[1]))
        a_r, a_i = torch.where(done, zero, a_r), torch.where(done, zero, a_i)
        pending = (a_r, a_i, d)
        r = torch.stack([r[0] - (a_r * q[0] - a_i * q[1]),
                         r[1] - (a_r * q[1] + a_i * q[0])])
        dn = rr(r)
        hist.append(tsc._hist_row(dn))
        b_r, b_i = tsc._cdiv(dn[0], dn[1], torch.where(done, 1.0, delta[0]),
                             torch.where(done, 0.0, delta[1]))
        beta = torch.stack([torch.where(done, zero, b_r),
                            torch.where(done, zero, b_i)])
        delta = dn
    if pending is not None:
        a_r, a_i, dp = pending
        x = torch.stack([x[0] + a_r * dp[0] - a_i * dp[1],
                         x[1] + a_r * dp[1] + a_i * dp[0]])
    return x, torch.stack(hist)


@pytest.mark.parametrize("name,nv,nh,iters,frozen", [
    ("7-point", 37, 45, 0, False), ("7-point", 37, 45, 1, False),
    ("7-point", 37, 45, 30, False), ("13-point", 33, 129, 25, False),
    ("7-point", 16, 16, 12, True)])
def test_deferred_x_update_is_bit_equal_to_plain(name, nv, nh, iters,
                                                 frozen):
    """The kernel defers x += alpha d' into the next phase A (JAX's qx):
    the deferred iteration gives the plain version's x and history bit for
    bit, from a nonzero x0, with 0 and 1 iterations, and on 2 I, which
    freezes after one iteration (alpha = 0 from then on)."""
    half = HALVES[name]
    if frozen:
        c = torch.zeros((len(half), nv, nh), dtype=torch.complex128)
        c[0] = 2.0
        mirrors = [tss._shift(c[t], dm, dj) for t, (dm, dj) in
                   enumerate(half) if t > 0]
        S = Stencil2D(tuple(half) + tuple((-dm, -dj) for dm, dj in half[1:]),
                      torch.cat([c, torch.stack(mirrors)]), (nv, nh))
    else:
        S = _sym_stencil(half, nv, nh, 7 * nv + nh)
    half_s, cplanes = tss.prepare_stream_sym(S)
    rng = np.random.default_rng(iters + nv)
    bp = torch.from_numpy(rng.standard_normal((2, nv, nh)).astype(np.float32))
    x0p = 0.1 * torch.from_numpy(
        rng.standard_normal((2, nv, nh)).astype(np.float32))
    xd, hd = _deferred_x_cocg(half_s, cplanes, bp, x0p, iters)
    xp, hp = tss.stream_cg_sym_planes_plain(half_s, cplanes, bp, x0p, iters)
    assert torch.equal(xd, xp) and torch.equal(hd, hp)
    if frozen:
        assert torch.all(hp[2:] == 0)

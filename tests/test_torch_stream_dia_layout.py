"""The launch layout of kernel A (``csrc/stream_cg_dia.cu``), on the CPU.

Each block of a launch owns one tile of consecutive rows
(``stream_cg_dia.tile_rows``: n over the SM count, rounded up to 32 rows,
at least 512) and, where its window of the direction (the tile's rows and
``max|off|`` rows each side, every RHS and plane) fits the block's shared
memory beside the tap list, stages it there once an iteration
(``dia_layout``).  A band whose tiles of n over 16 blocks, with their
values and their windows sized for 8 RHS, fit a block's shared memory runs
as one thread-block cluster instead (cluster mode).  These tests hold the
tiles to that rule at the Fig. 5 shapes and at sizes around its corners,
hold the tiles to one an SM and to the RHS count not moving them (a RHS's
bits rest on it), hold the window's bytes and the staged-or-direct choice
to the kernel's note, and hold the Python mirror of the shared-memory
arithmetic to the constants of the kernel's source.  The card tests
(tests/test_torch_cuda.py) hold the rule to the kernel's own answer.
"""
import contextlib
import pathlib
import re
import types

import pytest
import torch

from tpcg_torch import trace
from tpcg_torch.ops import _build, _tiles
from tpcg_torch.ops import stream_cg_dia as tsd

H100_SMS = 132
M_T1 = (0,) + tuple(o for k in range(1, 51) for o in (37 * k, -37 * k))
HELM_FEM = (0, 1, -1, 128, -128, 129, -129)
PARABOLIC = (0, 1, -1, 725, -725, 726, -726)
# helm_oras_m4's subdomain block (66 x 66 nodes, n 4,356), complex
ORAS = (-67, -66, -1, 0, 1, 66, 67)
BUDGET = _tiles.BLOCK_SHARED - tsd._STATIC_SMEM


@pytest.mark.parametrize("n,offsets,rows,tiles,cluster", [
    (97_578, M_T1, 768, 128, 0),       # m_t1: 127 tiles of 768, one of 42
    (16_384, HELM_FEM, 1024, 16, 16),  # helm_fem: one cluster of 16 blocks
    (525_625, PARABOLIC, 4000, 132, 0),
    (1280, tuple(range(-8, 9)), 512, 3, 3),
])
def test_tiles_at_the_fig5_shapes(n, offsets, rows, tiles, cluster):
    for planes in (1, 2):
        for nb in (1, 8):
            lay = tsd.dia_layout(n, offsets, nb, planes, H100_SMS)
            assert (lay.tile_rows, lay.tiles, lay.cluster) == (
                rows, tiles, cluster)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("n", [1, 31, 512, 513, 67_584, 67_585, 97_578,
                               525_625, 2**31 - 3001])
def test_tiles_cover_the_rows_at_most_one_an_sm(n, sms):
    """The cooperative grid's tiles (cluster mode has its own test)."""
    rows = tsd.tile_rows(n, sms)
    tiles = tsd.dia_layout(n, (0, 1, -1), 1, 1, sms, cluster=0).tiles
    assert rows % 32 == 0 and rows >= tsd.TILE_ROWS_MIN
    assert (tiles - 1) * rows < n <= tiles * rows
    assert tiles <= sms
    if rows > tsd.TILE_ROWS_MIN:
        # no smaller multiple of 32 keeps one tile an SM
        assert -(-n // (rows - 32)) > sms


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("n,offsets", [(97_578, M_T1), (16_384, HELM_FEM),
                                       (20_000, (0, 6000, -6000)),
                                       (4356, ORAS)])
def test_tiles_do_not_depend_on_the_rhs_count(n, offsets, planes):
    lays = [tsd.dia_layout(n, offsets, nb, planes, H100_SMS)
            for nb in range(1, 9)]
    assert len({(lay.tile_rows, lay.tiles, lay.cluster)
                for lay in lays}) == 1


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
    # helm_fem as a cooperative grid, complex, 1 RHS: (512 + 258 + 3 ->
    # 776) rows x 2 planes x 4 B
    assert tsd.dia_layout(16_384, HELM_FEM, 1, 2, H100_SMS,
                          cluster=0).smem == 6208 + ring + 28
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


# ---- cluster mode

def _source_constant(name):
    src = (pathlib.Path(tsd.__file__).parent.parent / "csrc"
           / "stream_cg_dia.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_cluster_mirror_agrees_with_the_kernel_source():
    """The Python side's limits and shared-memory arithmetic are the
    kernel's: at most 16 blocks a cluster and 8 RHS a launch, 384 threads
    of 3 rows each keeping a tile of up to 1152 rows in registers, and a
    block's bytes (the slots of C x 8 B a RHS for two partials, 4
    mbarriers, the window, the values, the taps)."""
    assert _source_constant("kMaxCluster") == tsd.MAX_CLUSTER == 16
    assert _source_constant("kMaxRhs") == tsd._MAX_RHS
    assert _source_constant("kMaxDiags") == tsd._MAX_DIAGS
    assert _source_constant("kThreads") * _source_constant("kRows") * 4 \
        * _source_constant("kDepth") == tsd.RING_BYTES
    # helm_fem, complex, 1 RHS, tiles of 1024 rows: slots 256 B, mbarriers
    # 32 B, window (1024 + 258 + 3 -> 1288) x 2 x 4 B, values 2 x 7 x 1024
    # x 4 B, taps 7 x 4 B
    assert tsd.cluster_smem(1024, HELM_FEM, 1, 2) == \
        256 + 32 + 10_304 + 57_344 + 28
    assert tsd.dia_layout(16_384, HELM_FEM, 1, 2, H100_SMS).smem == 67_964
    assert tsd.dia_layout(16_384, HELM_FEM, 8, 2, H100_SMS).smem == \
        2048 + 32 + 8 * 10_304 + 57_344 + 28


@pytest.mark.parametrize("n,offsets,planes,cluster", [
    (16_384, HELM_FEM, 2, True),       # helm_fem
    (16_384, HELM_FEM, 1, True),
    (28_000, HELM_FEM, 2, True),
    (30_000, HELM_FEM, 2, False),      # complex: 2 x 8 RHS windows too big
    (57_000, HELM_FEM, 1, True),       # real holds about twice the rows
    (60_000, HELM_FEM, 1, False),
    (97_578, M_T1, 1, False),          # m_t1: the 39 MB band
    (4000, tuple(range(-1850, 1851, 37)), 1, False),
    (525_625, PARABOLIC, 1, False),    # parabolic_fem as DIA
    (777, (0, 1, 3, 40), 1, True),
    (4, (0, 1, -1), 2, True),
])
def test_cluster_rule(n, offsets, planes, cluster):
    """Cluster mode exactly where the cluster's tiles, their values and
    their windows sized for 8 RHS fit a block's shared memory, at 1 RHS and
    8 alike; m_t1's shape and parabolic_fem as DIA keep the cooperative
    grid."""
    budget = _tiles.BLOCK_SHARED - tsd._STATIC_SMEM
    rows = tsd.cluster_tile_rows(n, H100_SMS)
    assert (tsd.cluster_smem(rows, offsets, 8, planes) <= budget) == cluster
    for nb in (1, 8):
        lay = tsd.dia_layout(n, offsets, nb, planes, H100_SMS)
        assert bool(lay.cluster) == cluster and not (lay.cluster and
                                                     lay.staged)
        if cluster:
            assert lay.smem == tsd.cluster_smem(rows, offsets, nb, planes)


@pytest.mark.parametrize("n", [1, 31, 512, 513, 8192, 8193, 16_384,
                               16_385, 20_000, 28_000])
def test_cluster_tiles_cover_the_rows(n):
    """One cluster of at most 16 blocks, each a tile of a multiple of 32
    rows (at least the cooperative tile), every block holding rows."""
    lay = tsd.dia_layout(n, HELM_FEM, 1, 2, H100_SMS)
    assert lay.cluster == lay.tiles and 1 <= lay.tiles <= tsd.MAX_CLUSTER
    rows = lay.tile_rows
    assert rows % 32 == 0 and rows >= tsd.tile_rows(n, H100_SMS)
    assert (lay.tiles - 1) * rows < n <= lay.tiles * rows
    if rows > tsd.TILE_ROWS_MIN:
        # no smaller multiple of 32 keeps the cluster within 16 blocks
        assert -(-n // (rows - 32)) > tsd.MAX_CLUSTER


def test_cluster_size_override():
    """dia_layout(cluster=C), for probes and tests: C blocks of n over C
    rows (rounded up to 32); cluster=0 the cooperative grid."""
    lay = tsd.dia_layout(16_384, HELM_FEM, 1, 2, H100_SMS, cluster=8)
    assert (lay.tile_rows, lay.tiles, lay.cluster) == (2048, 8, 8)
    assert lay.smem == tsd.cluster_smem(2048, HELM_FEM, 1, 2)
    lay = tsd.dia_layout(16_384, HELM_FEM, 1, 2, H100_SMS, cluster=0)
    assert (lay.tile_rows, lay.tiles, lay.cluster) == (512, 32, 0)
    assert lay.staged


# ---- clusters side by side

@pytest.mark.parametrize("active,nrhs,k,g", [
    # a card that holds 10 clusters of the ORAS block's 9 blocks at once
    (10, 1, 1, 1), (10, 8, 1, 8), (10, 9, 1, 9), (10, 16, 2, 8),
    # one that holds 7: 9 RHS as 5 clusters of 2, the last of 1
    (7, 1, 1, 1), (7, 8, 2, 4), (7, 9, 2, 5), (7, 16, 3, 6),
    # one that holds 2 at 8 RHS a cluster, and one that holds 1
    (2, 16, 8, 2), (1, 8, 8, 1), (1, 1, 1, 1)])
def test_cluster_split_at_the_oras_block(active, nrhs, k, g):
    """The ORAS block runs as clusters of 9 blocks of 512 rows at every RHS
    count; a batch takes the fewest RHS a cluster whose clusters the card
    holds at once."""
    for nb in range(1, 9):
        lay = tsd.dia_layout(4356, ORAS, nb, 2, H100_SMS)
        assert (lay.tile_rows, lay.tiles, lay.cluster) == (512, 9, 9)
    assert tsd.cluster_split(nrhs, lambda kk: active) == (k, g)


def test_cluster_split_reads_each_instance_count():
    """The count is the k-RHS instance's own: a card that holds 14 clusters
    of the 1- and 2-RHS instances and 6 of the larger ones takes 2 RHS a
    cluster for 16 and for 28, and 5 a cluster for 29 (6 clusters, the last
    of 4)."""
    def active(k):
        return 14 if k <= 2 else 6
    assert tsd.cluster_split(16, active) == (2, 8)
    assert tsd.cluster_split(28, active) == (2, 14)
    assert tsd.cluster_split(29, active) == (5, 6)
    assert tsd.cluster_split(48, active) == (8, 6)
    assert tsd.cluster_split(49, active) is None


@pytest.mark.parametrize("active", [0, 1, 2, 5, 9, 10, 16, 20])
def test_cluster_split_never_exceeds_the_co_resident_count(active):
    """For 1..200 RHS: G clusters of k RHS hold every RHS once (the last
    cluster holds 1..k), G is at most the card's count, no smaller k fits,
    and only a batch past 8 RHS a cluster on every cluster the card holds
    gets no split (the caller then splits it into launches)."""
    for nrhs in range(1, 201):
        split = tsd.cluster_split(nrhs, lambda k: active)
        if split is None:
            assert -(-nrhs // tsd._MAX_RHS) > active
            continue
        k, g = split
        assert 1 <= k <= tsd._MAX_RHS and g <= active
        assert (g - 1) * k < nrhs <= g * k
        assert all(-(-nrhs // kk) > active for kk in range(1, k))


def test_cluster_resident_mirrors_the_kernel():
    """x, r and q stay in registers where planes x RHS x 3 rows <= 16 and a
    tile is one pass of 384 threads x 3 rows: complex up to 2 RHS a
    cluster, real up to 5, the kernel's constants."""
    assert _source_constant("kClusterRows") == tsd.CLUSTER_ROWS == 3
    assert _source_constant("kThreads") == tsd._THREADS == 384
    assert [nb for nb in range(1, 9) if tsd.cluster_resident(512, nb, 2)] \
        == [1, 2]
    assert [nb for nb in range(1, 9) if tsd.cluster_resident(1152, nb, 1)] \
        == [1, 2, 3, 4, 5]
    assert not tsd.cluster_resident(1184, 1, 1)


class _FakeCard:
    """Stands in for the kernel library on a card of 132 SMs that holds
    ``active(k)`` clusters of kernel A's k-RHS instance at once: answers
    kernel A's queries and records its launches' arguments."""

    def __init__(self, active):
        self.active = active
        self.launches = []

    def tpcg_error_string(self, err):
        return b"fake error"

    def tpcg_stream_dia_limits(self, rhs, diags):
        rhs._obj.value, diags._obj.value = tsd._MAX_RHS, tsd._MAX_DIAGS
        return 0

    def tpcg_stream_dia_grid(self, cplx, nb, n, ndiag, pad, rows, staged,
                             cluster, grid, clusters):
        grid._obj.value = cluster or -(-n // rows)
        clusters._obj.value = self.active(nb) if cluster else 0
        return 0

    def tpcg_stream_dia(self, *args):
        self.launches.append(args)
        return 0


@pytest.fixture
def card(monkeypatch):
    """A function of a co-resident count (a number or a function of k)
    that puts a :class:`_FakeCard` in place of the library, and the CPU in
    place of its device."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=H100_SMS))

    def make(active):
        lib = _FakeCard(active if callable(active) else lambda k: active)
        monkeypatch.setattr(_build, "load", lambda: lib)
        return lib
    tsd._grid.cache_clear()
    trace.clear()
    yield make
    tsd._grid.cache_clear()
    trace.clear()


# tpcg_stream_dia's arguments: r, q, dpad; RHS a cluster (or the launch),
# cluster, grid, clusters, the batch's RHS
_R, _Q, _DPAD, _NB, _CLUSTER, _GRID, _CLUSTERS, _NB_ALL = (7, 8, 9, 14, 19,
                                                           20, 21, 22)


def _operands(n, offsets, planes, nrhs):
    values = torch.zeros((planes, len(offsets), n))
    b = torch.ones((planes, nrhs, n))
    return values, b, torch.zeros_like(b)


@pytest.mark.parametrize("active,k,g", [(10, 2, 8), (7, 3, 6), (2, 8, 2)])
def test_oras_batch_is_one_launch_of_clusters(card, active, k, g):
    """The ORAS block's 16 RHS on a card that holds ``active`` clusters:
    one launch of G clusters of k RHS (9 blocks of 512 rows each), the
    batch's 16 RHS passed whole, r and q left out where k <= 2 (resident);
    ``launch.*`` and ``cluster.*`` count 1 and ``cluster_grid.*`` G."""
    lib = card(active)
    values, b, x0 = _operands(4356, ORAS, 2, 16)
    assert tsd._launch_rhs(ORAS, values, "cpu") == 8 * active
    x, hist = tsd._launch(ORAS, values, b, x0, 3)
    assert x.shape == b.shape and hist.shape == (4, 16)
    args, = lib.launches
    assert (args[_NB], args[_CLUSTER], args[_GRID], args[_CLUSTERS],
            args[_NB_ALL]) == (k, 9, 9, g, 16)
    assert args[_DPAD] is None
    assert (args[_R] is None) == (args[_Q] is None) == (k <= 2)
    assert trace.counters() == {"launch.stream_dia_cplx": 1,
                                "cluster.stream_dia_cplx": 1,
                                "cluster_grid.stream_dia_cplx": g}


def test_cooperative_layouts_are_never_grouped(card):
    """A band past a cluster's shared memory (m_t1's offsets at n = 4000)
    keeps the cooperative grid: at most 8 RHS a launch, one launch each,
    no cluster counted; 9 RHS are refused by one launch."""
    lib = card(10)
    values, b, x0 = _operands(4000, M_T1, 1, 8)
    assert not tsd.dia_layout(4000, M_T1, 8, 1, H100_SMS).cluster
    assert tsd._launch_rhs(M_T1, values, "cpu") == 8
    tsd._launch(M_T1, values, b, x0, 3)
    args, = lib.launches
    assert (args[_NB], args[_CLUSTER], args[_CLUSTERS], args[_NB_ALL]) == (
        8, 0, 1, 8)
    assert args[_DPAD] is not None and args[_R] is not None
    assert trace.counters() == {"launch.stream_dia": 1, "staged.stream_dia": 1}
    values, b, x0 = _operands(4000, M_T1, 1, 9)
    with pytest.raises(ValueError, match="at most 8 RHS"):
        tsd._launch(M_T1, values, b, x0, 3)


def test_a_card_that_holds_no_cluster_takes_the_cooperative_grid(card):
    """Where the card holds no cluster of the layout, a band that fits one
    runs as the cooperative grid, 8 RHS a launch."""
    lib = card(0)
    values, b, x0 = _operands(4356, ORAS, 2, 8)
    assert tsd._launch_rhs(ORAS, values, "cpu") == 8
    tsd._launch(ORAS, values, b, x0, 3)
    args, = lib.launches
    assert (args[_NB], args[_CLUSTER], args[_CLUSTERS]) == (8, 0, 1)
    assert "cluster.stream_dia_cplx" not in trace.counters()

"""The launch seam of ``tpcg_torch.ops._build`` on the CPU.

Every kernel wrapper reaches the library through ``_build.query`` (the
entry points that return ints through pointers) and ``_build.launch`` (the
kernels).  Here a fake library stands in for ``_build.load()``: it checks
that each call passes as many arguments as ``_build._SIGNATURES``
declares, writes the out-values of a query, and records the calls.  The
launches themselves run on the card in ``tests/test_torch_cuda.py``.
"""
import contextlib
import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

from tpcg_torch import trace
from tpcg_torch.ops import (_build, fused_cg_const, fused_cg_dia, route_spmv,
                            stream_cg, stream_cg_coef, stream_cg_dia,
                            stream_cg_real, stream_cg_sym)
from tpcg_torch.problems import helm_fe, poisson
from tpcg_torch.sparse import DiaMatrix

# the package exports a function named fused_cg that hides the module
fused_cg = importlib.import_module("tpcg_torch.ops.fused_cg")

CPU = torch.device("cpu")
STREAM = 0x5EA              # the fake current stream's handle
OUT = 16                    # every out-value the fake library writes


class FakeLib:
    """A stand-in for the kernel library: each entry point of
    ``_SIGNATURES`` records its arguments, writes ``OUT`` through each
    out-pointer and returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def tpcg_error_string(self, err):
        return b"fake error"

    def __getattr__(self, entry):
        sig = _build._SIGNATURES[entry]

        def call(*args):
            assert len(args) == len(sig), (entry, len(args), len(sig))
            self.calls.append((entry, args))
            for arg in args:
                if isinstance(arg, type(ctypes.byref(ctypes.c_int()))):
                    arg._obj.value = OUT
            return self.err
        return call


@pytest.fixture
def fake(monkeypatch):
    """The fake library in place of the built one, and the CPU in place of
    a CUDA device: ``torch.cuda.device`` enters nothing, the current stream
    is ``STREAM`` and the card has 132 SMs."""
    lib = FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    # kernel A's grid answers are kept a process: none from another fake
    stream_cg_dia._grid.cache_clear()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    trace.clear()
    yield lib
    trace.clear()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def test_query_returns_the_out_values(fake):
    assert _build.query("tpcg_stream_cg_limits") == (OUT, OUT, OUT)
    assert _build.query("tpcg_fused_cg_grid", 100) == (OUT,)
    (entry, (n, out)), = fake.calls[1:]
    assert entry == "tpcg_fused_cg_grid" and n == 100
    assert trace.counters() == {}


def test_query_raises_naming_the_entry(fake):
    fake.err = 2
    with pytest.raises(RuntimeError,
                       match=r"tpcg_fused_cg_grid: CUDA error 2 \(fake"):
        _build.query("tpcg_fused_cg_grid", 100)


def test_launch_counts_each_call_in_its_span(fake):
    def launch():
        with _build.launch("route_spmv", CPU) as run:
            run("tpcg_route_spmv", *range(11))
            run("tpcg_route_spmv", *range(11))
    _profiled(launch)
    assert [args[-1] for _, args in fake.calls] == [STREAM, STREAM]
    assert trace.counters() == {"launch.route_spmv": 2}
    rec, = trace.records()
    assert rec.name == "tpcg.launch.route_spmv"
    assert rec.counts == {"launch.route_spmv": 2}


def test_failed_launch_raises_naming_the_entry_and_counts_nothing(fake):
    fake.err = 700

    def launch():
        with _build.launch("fused_dia", CPU) as run:
            run("tpcg_fused_dia", *range(11))
    with pytest.raises(RuntimeError,
                       match=r"tpcg_fused_dia: CUDA error 700 \(fake"):
        _profiled(launch)
    assert trace.counters() == {}
    assert [r.name for r in trace.records()] == ["tpcg.launch.fused_dia"]


def _stencil_planes(S, nb):
    nv, nh = S.grid
    return torch.ones((2, nb, nv, nh)), torch.zeros((2, nb, nv, nh))


def _fused_cg():
    S = helm_fe(8, 2.0, eps=2.0, device="cpu")
    b, x0 = _stencil_planes(S, 2)
    return fused_cg._launch(S.offsets, fused_cg.prepare_coef3(S), b, x0, 3)


def _fused_const():
    S = helm_fe(8, 2.0, eps=2.0, device="cpu")
    cr, ci, strips = fused_cg_const.prepare_const(S)
    b, x0 = _stencil_planes(S, 2)
    return fused_cg_const._launch(S.offsets, S.grid, cr, ci, strips, b, x0, 3)


def _stream_const():
    S = helm_fe(8, 2.0, eps=2.0, device="cpu")
    taps, strips = stream_cg.prepare_stream(S)
    b, x0 = _stencil_planes(S, 3)
    return stream_cg._launch(S.offsets, S.grid, taps, strips, b, x0, 3,
                             chunk=2)


def _stream_coef():
    S = helm_fe(8, 2.0, eps=2.0, device="cpu")
    b, x0 = _stencil_planes(S, 2)
    return stream_cg_coef._launch(S.offsets, stream_cg_coef.
                                  prepare_stream_coef(S), b, x0, 3)


def _stream_sym():
    S = helm_fe(8, 2.0, eps=2.0, device="cpu")
    half, cplanes = stream_cg_sym.prepare_stream_sym(S)
    b, x0 = _stencil_planes(S, 1)
    return stream_cg_sym._launch(half, cplanes, b[:, 0], x0[:, 0], 3, None)


def _stream_real():
    S = poisson(8, device="cpu")
    taps, strips = stream_cg_real.prepare_stream_real(S)
    b = torch.ones(S.grid)
    return stream_cg_real._launch(S.offsets, strips, taps, b,
                                  torch.zeros_like(b), 3)


def _dia(planes):
    n = 40
    A = (np.diag(np.full(n, 4.0)) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    D = DiaMatrix.from_scipy(A.astype(np.complex64 if planes == 2
                                      else np.float32), device="cpu")
    prep = (stream_cg_dia.prepare_dia_rows_cplx if planes == 2
            else stream_cg_dia.prepare_dia_rows)
    offsets, values = prep(D)
    values = values.reshape(planes, len(offsets), n)
    b = torch.ones((planes, 2, n))
    return offsets, values, b, torch.zeros_like(b)


def _stream_dia():
    return stream_cg_dia._launch(*_dia(1), 3)


def _stream_dia_cplx():
    return stream_cg_dia._launch(*_dia(2), 3)


def _fused_dia():
    return fused_cg_dia._launch(*_dia(2), 3)


def _route_spmv():
    # 11 columns: launches of 8, 2 and 1
    row_ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    col = torch.tensor([1, 0], dtype=torch.int32)
    return route_spmv._launch(row_ptr, col, torch.ones(2),
                              torch.ones((2, 11)), None)


# kernel: (its wrapper's launch on the CPU, C entry point, C calls)
WRAPPERS = {
    "fused_cg": (_fused_cg, "tpcg_fused_cg_stencil", 1),
    "fused_const": (_fused_const, "tpcg_fused_cg_const", 1),
    "stream_const": (_stream_const, "tpcg_stream_cg", 2),
    "stream_coef": (_stream_coef, "tpcg_stream_coef", 1),
    "stream_sym": (_stream_sym, "tpcg_stream_sym", 1),
    "stream_real": (_stream_real, "tpcg_stream_real", 1),
    "stream_dia": (_stream_dia, "tpcg_stream_dia", 1),
    "stream_dia_cplx": (_stream_dia_cplx, "tpcg_stream_dia", 1),
    "fused_dia": (_fused_dia, "tpcg_fused_dia", 1),
    "route_spmv": (_route_spmv, "tpcg_route_spmv", 3),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_every_wrapper_launches_through_the_seam(fake, kernel):
    """Each kernel's wrapper passes its C entry point the declared number of
    arguments with the current stream last, inside one span
    ``tpcg.launch.<kernel>`` that counts ``launch.<kernel>`` once a call."""
    run, entry, calls = WRAPPERS[kernel]
    _profiled(run)
    launches = [args for name, args in fake.calls if name == entry]
    assert len(launches) == calls
    assert all(args[-1] == STREAM for args in launches)
    assert trace.counters()["launch." + kernel] == calls
    spans = [r for r in trace.records() if r.name.startswith("tpcg.launch.")]
    assert [r.name for r in spans] == ["tpcg.launch." + kernel]
    assert spans[0].counts["launch." + kernel] == calls


def _stream_real_call(fake, n):
    """One const-mode launch of the real streaming kernel on Poisson n x n
    through the fake library; returns the kernel's arguments."""
    S = poisson(n, device="cpu")
    taps, strips = stream_cg_real.prepare_stream_real(S)
    b = torch.ones(S.grid)
    stream_cg_real._launch(S.offsets, strips, taps, b, torch.zeros_like(b), 3)
    (_, args), = [c for c in fake.calls if c[0] == "tpcg_stream_real"]
    return args


def test_resident_launch_is_counted_and_allocates_no_q(fake):
    """16 x 16 at 132 SMs: 16 tiles of one row, one a block (the fake card
    holds 16 blocks): the launch passes resident 1, no q and no working x,
    and counts ``resident.stream_real`` beside ``launch.stream_real``."""
    args = _stream_real_call(fake, 16)
    q, xw, coef, resident, rows, grid = (args[6], args[8], args[17],
                                         args[18], args[20], args[-2])
    assert (q, xw, coef, resident, rows, grid) == (None, None, 0, 1, 1, 16)
    assert trace.counters() == {"launch.stream_real": 1,
                                "resident.stream_real": 1}


def test_resident_layout_falls_back_where_the_card_holds_fewer(fake,
                                                              monkeypatch):
    """Where the occupancy query finds the card cannot hold one block a tile
    of the resident layout (the grid query gives 0), the launch takes the
    streaming layout: q and the working x allocated, no resident count."""
    query = _build.query

    def no_resident(entry, *args):
        if entry == "tpcg_stream_real_grid" and args[6]:
            return (0,)
        return query(entry, *args)
    monkeypatch.setattr(_build, "query", no_resident)
    args = _stream_real_call(fake, 16)
    assert args[6] is not None and args[8] is not None
    assert (args[18], args[20]) == (0, stream_cg_real.SMALL_TILE_ROWS)
    assert trace.counters() == {"launch.stream_real": 1}

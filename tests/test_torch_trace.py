"""The port's spans and counters (``tpcg_torch.trace``) on the CPU.

The spans of ``tpcg_torch.cg`` and ``cg_matrix`` nest as the call's layers
do, share the profiler's clock, record only under ``torch.profiler``, and
are what the benchmark's per-layer readers read (``bench_torch/metrics``:
``convert_ms``, ``copy_ms``, ``copy_mb``, ``launches``).  The card's spans
and byte counts are held in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpcg_torch
from tpcg_torch import trace
from tpcg_torch.device import download, upload
from tpcg_torch.problems import banded_spd, helm_fe, plane_wave_rhs

CPU = torch.profiler.ProfilerActivity.CPU


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _helm_csr(N=12, k=5.0):
    A = helm_fe(N, k, eps=k, device="cpu").to_scipy().tocsr()
    A = A.astype(np.complex64)
    A.sort_indices()
    return A


def _cg(A, b, **kw):
    return tpcg_torch.cg(A.shape[0], A.nnz, A.data, b, A.indptr, A.indices,
                         n_iterations=5, device="cpu", **kw)


def _profiled(fn):
    with torch.profiler.profile(activities=[CPU]) as prof:
        out = fn()
    return out, prof


def _names(recs):
    return [r.name for r in recs]


def _check_tree(recs):
    """Every record's parent opened before it, in its call, and holds it."""
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is None:
            assert r.call == r.id
            continue
        p = by_id[r.parent]
        assert p.call == r.call and p.id < r.id
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_cg_span_tree_on_a_banded_csr():
    A = _helm_csr()
    b = plane_wave_rhs(12, 5.0).reshape(-1).astype(np.complex64)
    _profiled(lambda: [_cg(A, b), _cg(A, b)])
    recs = trace.records()
    _check_tree(recs)
    tops = [r for r in recs if r.parent is None]
    assert _names(tops) == ["tpcg.cg", "tpcg.cg"]
    for top in tops:
        call = [r for r in recs if r.call == top.id]
        # helm_fe is banded in its natural order: no RCM; on the CPU nothing
        # is uploaded, waited for or downloaded
        assert _names(call) == ["tpcg.cg", "tpcg.convert", "tpcg.convert.dia",
                                "tpcg.pack", "tpcg.pack"]
        conv = call[1]
        assert [r.parent for r in call] == [None, top.id, conv.id, top.id,
                                            top.id]
        assert top.counts == {}


def test_cg_runs_rcm_where_the_natural_order_is_not_banded():
    n = 300
    T = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    p = np.random.default_rng(3).permutation(n)
    A = sp.csr_matrix(T[p][:, p], dtype=np.float32)
    A.sort_indices()
    b = np.ones(n, np.float32)
    x, _ = _profiled(lambda: _cg(A, b))
    assert _names(trace.records()) == [
        "tpcg.cg", "tpcg.convert", "tpcg.convert.rcm", "tpcg.convert.dia",
        "tpcg.pack", "tpcg.pack"]
    _check_tree(trace.records())
    x0 = _cg(A, b)                    # the same answer untraced
    np.testing.assert_array_equal(x, x0)


def test_cg_matrix_span_tree():
    D = tpcg_torch.DiaMatrix.from_scipy(banded_spd(200, 3, seed=1),
                                        dtype=np.float32, device="cpu")
    S = sp.csr_matrix(banded_spd(200, 3, seed=1))
    b = np.ones(2 * 200, np.float32)
    _profiled(lambda: [
        tpcg_torch.cg_matrix(D, b, n_rhs=2, n_iterations=5),
        tpcg_torch.cg_matrix(S, b, n_rhs=2, n_iterations=5, device="cpu")])
    recs = trace.records()
    _check_tree(recs)
    tops = [r for r in recs if r.parent is None]
    assert _names(tops) == ["tpcg.cg_matrix", "tpcg.cg_matrix"]
    calls = [[r.name for r in recs if r.call == t.id] for t in tops]
    assert calls == [
        ["tpcg.cg_matrix", "tpcg.pack", "tpcg.pack"],
        ["tpcg.cg_matrix", "tpcg.convert", "tpcg.convert.dia", "tpcg.pack",
         "tpcg.pack"]]


def test_records_bracket_their_profiler_events():
    A = _helm_csr()
    b = np.ones(A.shape[0], np.complex64)
    _, prof = _profiled(lambda: [_cg(A, b) for _ in range(3)])
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(trace.PREFIX):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    recs = trace.records()
    assert sorted(events) == sorted({r.name for r in recs})
    for name, evs in events.items():
        mine = [r for r in recs if r.name == name]
        assert len(mine) == len(evs)
        for r, (s, e) in zip(mine, sorted(evs)):
            assert r.start_ns <= s <= e <= r.end_ns, name
            assert (r.end_ns - r.start_ns) - (e - s) < 1_000_000, name


def test_untraced_calls_record_nothing():
    A = _helm_csr()
    b = np.ones(A.shape[0], np.complex64)
    assert not torch.autograd._profiler_enabled()
    # one shared no-op: no record_function is entered, nothing allocated
    assert trace.span("cg") is trace.span("convert")
    x = _cg(A, b)
    tpcg_torch.cg_matrix(sp.csr_matrix(A), b, n_iterations=5, device="cpu")
    assert trace.records() == []
    _, prof = _profiled(lambda: None)
    assert not [ev for ev in prof.profiler.kineto_results.events()
                if ev.name().startswith(trace.PREFIX)]
    _profiled(lambda: _cg(A, b))
    assert _names(trace.records())[0] == "tpcg.cg"
    np.testing.assert_array_equal(x, _cg(A, b))


def test_counters_accumulate_and_go_to_the_open_spans():
    trace.count("a")
    trace.count("a", 4)
    assert trace.counters() == {"a": 5} and trace.records() == []

    def nested():
        with trace.span("outer"):
            trace.count("b", 2)
            with trace.span("inner"):
                trace.count("a")
            trace.count("c")
        trace.count("a")

    _profiled(nested)
    outer, inner = trace.records()
    assert (outer.name, inner.name) == ("tpcg.outer", "tpcg.inner")
    assert outer.counts == {"a": 1, "b": 2, "c": 1}
    assert inner.counts == {"a": 1}
    assert trace.counters() == {"a": 7, "b": 2, "c": 1}
    c = trace.counters()
    c["a"] = 0                        # a copy
    assert trace.counters()["a"] == 7
    trace.clear()
    assert trace.counters() == {} and trace.records() == []


def test_records_stop_at_the_cap_and_count_the_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)

    def many():
        with trace.span("top"):
            for _ in range(4):
                with trace.span("leaf"):
                    trace.count("n")

    _profiled(many)
    recs = trace.records()
    assert _names(recs) == ["tpcg.top", "tpcg.leaf", "tpcg.leaf"]
    assert trace.counters()[trace.DROPPED] == 2
    # the dropped spans' counts still add up in the spans kept
    assert recs[0].counts == {"n": 4, trace.DROPPED: 2}
    assert all(r.end_ns is not None for r in recs)


def test_copies_count_bytes_only_across_devices():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)

    def copies():
        t = upload(torch.from_numpy(a), "cpu", torch.float32)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert download(t) is not None
        m = upload(torch.from_numpy(a), "meta", torch.float32)
        assert m.device.type == "meta" and m.shape == (3, 4)

    _profiled(copies)
    assert _names(trace.records()) == ["tpcg.upload"]
    # the bytes that land, in the copy's dtype
    assert trace.counters() == {"h2d_bytes": 12 * 4}
    assert trace.records()[0].counts == {"h2d_bytes": 48}


@pytest.mark.parametrize("name", ["m_t1.block16", "helm_fem.csr_calls"])
def test_traced_bench_run_reads_the_spans(name):
    from bench_torch import run, spec
    cell = spec.cell(name)
    cell = dataclasses.replace(
        cell, config={**cell.config, **cell.config["cpu_test"]})
    result, _ = run.measure(cell, 2**32 + 7, 0.3, True, torch.device("cpu"))
    assert result["correct"], result["checks"]
    new = {"convert_ms", "copy_ms", "copy_mb", "launches"}
    reported = {m["name"] for m in cell.per_layer
                if m["name"].split(".")[0] in new}
    assert len(reported) == (4 if name == "helm_fem.csr_calls" else 3)
    got = result["metrics"]
    for m in reported:
        assert isinstance(got[m]["value"], float | int), m
    # on the CPU nothing crosses devices and no kernel launches
    kind = ".host" if name == "helm_fem.csr_calls" else ""
    assert got["copy_mb" + kind]["value"] == 0
    assert got["copy_ms" + kind]["value"] == 0
    assert got["launches" + kind]["value"] == 0
    if kind:
        assert got["convert_ms.host"]["value"] > 0
    # the warm-up request's call is not a timed one
    tops = [r for r in trace.records() if r.parent is None]
    assert len(tops) == result["attempted"] + 1


def test_traced_oras_run_reads_its_spans():
    """The helm_oras cell traced on the CPU at its ``cpu_test`` size: the
    calls' spans hold 7 precond and 7 arnoldi spans each, and nothing is
    launched or copied; ``precond_ms.host`` and ``arnoldi_ms.host``, which
    read kernel A's device time, give None where no kernel ran on a card,
    and in an untraced run."""
    from bench_torch import run, spec
    from bench_torch.metrics import arnoldi_ms, precond_ms
    cell = spec.cell("helm_oras_m4.source_calls")
    cfg = {**cell.config, **cell.config["cpu_test"]}
    cell = dataclasses.replace(cell, config=cfg)
    result, _ = run.measure(cell, 2**32 + 9, 0.3, True, torch.device("cpu"))
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert "precond_ms.host" not in got and "arnoldi_ms.host" not in got
    assert got["launches.host"] == 0 and got["copy_mb.host"] == 0
    tops = [r for r in trace.records() if r.parent is None]
    assert [r.name for r in tops] == ["tpcg.hsolve"] * (
        result["attempted"] + 1)
    names = [r.name for r in trace.records()]
    assert names.count("tpcg.precond") == names.count("tpcg.arnoldi") == \
        cfg["n_iterations"] * len(tops)

    class Untraced:
        trace = None
    assert precond_ms.read(Untraced()) is None
    assert arnoldi_ms.read(Untraced()) is None


def test_oras_readers_split_a_request_at_kernel_a():
    """``precond_ms`` sums kernel A's device time inside each request span
    (clipped to it, other kernels left out) and ``arnoldi_ms`` takes the
    rest of the request; both are means over the requests, in ms."""
    from bench_torch.metrics import arnoldi_ms, precond_ms
    from bench_torch.trace import Trace
    kern = "void stream_dia_kernel<true, 8, false, true>(Params)"
    # request 1: 3 + 1.5 ms of kernel A; request 2: 1.5 + 6 ms
    device = [(0.001, 0.004, kern), (0.004, 0.005, "gather_kernel"),
              (0.0085, 0.0115, kern),
              (0.013, 0.019, kern), (0.019, 0.0195, "gather_kernel")]
    spans = [(0.0, 0.010), (0.010, 0.020)]

    class Ctx:
        trace = Trace(device, [], spans)
    assert precond_ms.read(Ctx()) == pytest.approx(6.0)
    assert arnoldi_ms.read(Ctx()) == pytest.approx(4.0)
    Ctx.trace = Trace([d for d in device if d[2] != kern], [], spans)
    assert precond_ms.read(Ctx()) is None and arnoldi_ms.read(Ctx()) is None

"""The port's spans and counters: where a call's time and bytes go.

``span(name)`` marks one layer of a call (``tpcg.<name>``) and ``count(name,
n)`` adds to a counter.  Spans record only while a ``torch.profiler``
session is active; otherwise ``span`` returns a shared no-op context, so an
untraced call pays one C call a span.  While one is active, a span

* enters ``torch.profiler.record_function("tpcg.<name>")``, so it shows in
  the profiler's timeline beside the device activity, and
* appends a :class:`Record` to an in-memory list (at most ``MAX_RECORDS``;
  past it ``trace.dropped`` counts the spans not kept).  ``start_ns`` and
  ``end_ns`` are ``time.time_ns()`` taken just outside the
  ``record_function`` event, on the profiler's clock (Unix time in ns).

Counters are always on: a process-wide dict of integers (``counters()``).
While spans record, a count also adds to the ``counts`` of every open span,
so the outermost span of a call holds what the whole call counted.

The counters the program keeps:

* ``launch.<kernel>``: launches of each hand-written kernel (``stream_dia``,
  ``stream_dia_cplx``, ``fused_cg``, ``fused_const``, ``fused_dia``,
  ``stream_const``, ``stream_coef``, ``stream_sym``, ``stream_real``,
  ``route_spmv``), counted in one place, ``ops._build.launch``, once for
  each call into the library that succeeded, inside the span
  ``tpcg.launch.<kernel>`` that the same function opens;
* ``staged.stream_dia``, ``staged.stream_dia_cplx``: launches of kernel A
  (``csrc/stream_cg_dia.cu``) whose blocks staged their window of the
  direction in shared memory (a ``launch.*`` count too; not itself one);
* ``cluster.stream_dia``, ``cluster.stream_dia_cplx``: launches of kernel A
  that ran as one thread-block cluster (cluster mode, bands that fit the
  shared memory of at most 16 blocks; a ``launch.*`` count too; not itself
  one);
* ``copy.pad_sym_planes``, ``copy.pad_real_planes``: padded copies of a
  stencil's planes made for the kernels;
* ``plan.<path>``: plans of the stencil planner (``ops.auto``) by the path
  each took (``plan.stream-real``, ``plan.eager``, ...);
* ``h2d_bytes``, ``d2h_bytes``: bytes copied from host to device and back
  by ``device.upload`` and ``device.download``;
* ``fgmres.iterations``, ``precond.applies``, ``subsolve.rhs``: the
  ORAS-FGMRES solver's Arnoldi steps, preconditioner applications and
  subdomain RHS solved (``tpcg_torch.parallel``).

The state is the process's, for one thread: spans opened by two threads at
once would nest into each other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time

import torch

PREFIX = "tpcg."
MAX_RECORDS = 1 << 16
DROPPED = "trace.dropped"

_OFF = contextlib.nullcontext()
_counters: dict = {}
_records: list = []
_open: list = []              # the records of the spans open now, outermost first
_ids = itertools.count(1)


@dataclasses.dataclass(slots=True)
class Record:
    """One span: ``id``, its ``parent``'s id (None for a call's outermost
    span) and its ``call``'s (the outermost span's id), times in ns, and
    the counts made while it was open, its children's included."""
    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int | None = None
    counts: dict = dataclasses.field(default_factory=dict)


class _Span:
    __slots__ = ("name", "record", "event")

    def __init__(self, name: str):
        self.name = PREFIX + name

    def __enter__(self):
        i = next(_ids)
        parent = _open[-1] if _open else None
        rec = Record(self.name, i, parent.id if parent else None,
                     parent.call if parent else i, time.time_ns())
        self.event = torch.profiler.record_function(self.name)
        self.event.__enter__()
        _open.append(rec)
        self.record = rec
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
        else:
            count(DROPPED)
        return rec

    def __exit__(self, *exc):
        _open.pop()
        self.event.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        return False


def span(name: str):
    """A context for span ``tpcg.<name>``: it records while a profiler
    session is active, and is a shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to every open span's counts."""
    _counters[name] = _counters.get(name, 0) + n
    for rec in _open:
        rec.counts[name] = rec.counts.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counters)


def records() -> list:
    """The spans recorded, in the order they opened."""
    return list(_records)


def clear() -> None:
    """Forget the records and set every counter to zero."""
    _records.clear()
    _counters.clear()

"""The program's own spans and counters (``tpcg_torch.trace``) of the
traced window's requests, for the readers of ``convert_ms``, ``copy_ms``,
``copy_mb`` and ``launches``.

A call is the program's outermost span (``tpcg.cg``, ``tpcg.cg_matrix``)
with every span inside it; the calls kept are those whose midpoint lies
inside one of the harness's request spans (the untimed warm-up request
falls outside).  Records and the profiler's events share a clock (Unix time
in ns).  A program without ``tpcg_torch.trace``, or a run that was not
traced, gives None.
"""
from __future__ import annotations

import bisect


def calls(ctx):
    """[(outermost record, the call's records)] of the calls made inside
    the timed requests, or None where there is none."""
    if ctx.trace is None or not ctx.trace.spans:
        return None
    try:
        from tpcg_torch import trace
    except ImportError:
        return None
    spans = ctx.trace.spans
    starts = [s for s, _ in spans]

    def timed(rec):
        mid = (rec.start_ns + rec.end_ns) * 0.5e-9
        i = bisect.bisect_right(starts, mid) - 1
        return i >= 0 and mid <= spans[i][1]

    by_call = {}
    for rec in trace.records():
        by_call.setdefault(rec.call, []).append(rec)
    out = [(recs[0], recs) for call, recs in by_call.items()
           if recs[0].id == call and recs[0].end_ns is not None
           and timed(recs[0])]
    return out or None


def duration_s(rec) -> float:
    return (rec.end_ns - rec.start_ns) * 1e-9


def self_s(rec, recs) -> float:
    """``rec``'s duration less the part of it that its child spans cover
    (children of one span run one after another)."""
    return duration_s(rec) - sum(duration_s(c) for c in recs
                                 if c.parent == rec.id)


def per_call(ctx, value):
    """The mean of ``value(outermost, records)`` over the timed calls, or
    None where there is none."""
    found = calls(ctx)
    if not found:
        return None
    return sum(value(top, recs) for top, recs in found) / len(found)

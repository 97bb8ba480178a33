"""``copy_mb`` (layer: transfer): the bytes the program copies between host
and device, in MB (10^6 bytes) a call: its counters ``h2d_bytes`` and
``d2h_bytes`` over the call's outermost span."""
from bench_torch.program_spans import per_call


def _copy_bytes(top, recs):
    return top.counts.get("h2d_bytes", 0) + top.counts.get("d2h_bytes", 0)


def read(ctx):
    b = per_call(ctx, _copy_bytes)
    return None if b is None else b / 1e6

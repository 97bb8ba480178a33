"""``copy_ms`` (layer: transfer): the program's copies between host and
device, in ms a call: the durations of its spans ``tpcg.upload`` and
``tpcg.download`` (each a blocking copy from or to pageable memory)."""
from bench_torch.program_spans import duration_s, per_call


def _copy_s(top, recs):
    return sum(duration_s(r) for r in recs
               if r.name in ("tpcg.upload", "tpcg.download"))


def read(ctx):
    s = per_call(ctx, _copy_s)
    return None if s is None else s * 1e3

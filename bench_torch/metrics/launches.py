"""``launches`` (layer: kernels): launches of the program's hand-written
kernels a call, its counters ``launch.<kernel>`` over the call's outermost
span."""
from bench_torch.program_spans import per_call


def _launches(top, recs):
    return sum(n for k, n in top.counts.items() if k.startswith("launch."))


def read(ctx):
    return per_call(ctx, _launches)

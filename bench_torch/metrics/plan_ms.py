"""``plan_ms`` (layer: planner): the stencil planner's plan of a call, in ms
a call: the duration of the program's span ``tpcg.plan`` (the path's
choice, the kernel's operands and their constancy tests, the solver)."""
from bench_torch.program_spans import duration_s, per_call


def _plan_s(top, recs):
    return sum(duration_s(r) for r in recs if r.name == "tpcg.plan")


def read(ctx):
    s = per_call(ctx, _plan_s)
    return None if s is None else s * 1e3

"""``precond_ms`` (layer: preconditioner): the ORAS preconditioner's
subdomain solves in ms a request: the device time of kernel A
(``csrc/stream_cg_dia.cu``; in ``helm_oras`` it runs only in the batched
subdomain COCG of ``SchwarzPrec``, two launches an application) inside each
traced request, mean over the requests.  The program waits for nothing
extra while traced, so this is the untraced program's kernel time.  None
where no traced request ran kernel A."""
from __future__ import annotations

import bisect

from bench_torch.metrics.stream_cg_dia_roofline import KERNEL


def split_s(ctx):
    """[(request seconds, kernel A's device seconds inside it)] of the
    traced requests, or None where kernel A did not run in them."""
    tr = ctx.trace
    if tr is None or not tr.spans:
        return None
    runs = sorted((s, e) for s, e, n in tr.device if KERNEL.search(n))
    if not runs:
        return None
    starts = [s for s, _ in runs]
    out = []
    for s, e in tr.spans:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        inside = 0.0
        for a, b in runs[i:bisect.bisect_left(starts, e)]:
            inside += max(0.0, min(e, b) - max(s, a))
        out.append((e - s, inside))
    return out


def read(ctx):
    split = split_s(ctx)
    if split is None:
        return None
    return 1e3 * sum(k for _, k in split) / len(split)

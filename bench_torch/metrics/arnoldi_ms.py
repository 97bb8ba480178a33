"""``arnoldi_ms`` (layer: krylov): everything of a request but the
subdomain solves, in ms a request: a traced request's latency less kernel
A's device time inside it (``precond_ms``).  That is FGMRES's Arnoldi step
(the global matvec and its ring overwrite, CGS2, the Hessenberg column's
trip to the host, the Givens step), the exchanges and packing around the
subdomain solves, the request's copies, and the card's idle gaps between
them.  Mean over the traced requests; None where kernel A did not run in
them."""
from bench_torch.metrics.precond_ms import split_s


def read(ctx):
    split = split_s(ctx)
    if split is None:
        return None
    return 1e3 * sum(r - k for r, k in split) / len(split)

"""``gflops``: report Table II operations of every RHS solve completed in
the window, over the whole window (host clock), in GFLOP/s."""


def read(ctx):
    if not ctx.completed:
        return None
    return ctx.completed * ctx.request_ops / ctx.window_s / 1e9

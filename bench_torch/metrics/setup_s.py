"""``setup_s``: process start to the first timed request (imports, the
program's build or load of its kernels, assembly, planning, the RHS pool
and the warm-up request), in s."""


def read(ctx):
    return ctx.setup_s

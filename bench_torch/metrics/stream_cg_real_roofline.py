"""``stream_cg_real_roofline`` (layer: kernels): as
``stream_cg_dia_roofline``, for ``csrc/stream_cg_real.cu``'s kernel (the
planner's ``stream-real`` path)."""

import re

KERNEL = re.compile(r"\bstream_cg_real_kernel\b")


def read(ctx):
    return ctx.roofline(KERNEL)

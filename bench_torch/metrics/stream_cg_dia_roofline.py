"""``stream_cg_dia_roofline`` (layer: kernels): as ``fused_cg_roofline``,
for ``csrc/stream_cg_dia.cu``'s kernel (kernel A)."""

import re

KERNEL = re.compile(r"\bstream_dia_kernel\b")


def read(ctx):
    return ctx.roofline(KERNEL)

"""``device_mem_mb``: ``torch.cuda.max_memory_allocated()`` over set-up and
window, in MB (10^6 bytes)."""


def read(ctx):
    return ctx.memory_peak_bytes / 1e6 if ctx.memory_peak_bytes else None

"""``device_idle`` (layer: device): the share of the traced window, from
the first request's span to the last one's end, in which no kernel, copy
or memset ran on the card, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""``host_ms`` (layer: entry): the self time of the harness's span around
a request, its latency less the device activity (kernels, copies, memsets)
inside it, averaged over the traced window's requests, in ms."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    host = ctx.trace.host_s()
    return sum(host) / len(host) * 1e3

"""The ``--trace 1`` run: ``torch.profiler`` (CUPTI) over the window, the
harness's own span around each request, and the reduction of both to the
intervals that the per-layer readers read.

Device activity is every kernel, copy and memset that the trace shows on
the card.  All times are seconds on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import re

import torch

SPAN = "bench.request"          # the harness's span around one request
WARM = "bench.warm"             # the untimed request that warms CUPTI


def _merge(intervals):
    """Sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e):
    """Length of the part of [s, e] that merged intervals cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged
               if a < e and b > s)


class Trace:
    """What one traced window showed.

    device : [(start, end, name)] of every activity on the card;
    host   : [(start, end, name)] of the host's operations;
    spans  : [(start, end)] of the timed requests, in order.
    """

    def __init__(self, device, host, spans):
        self.spans = sorted(spans)
        self.window = ((self.spans[0][0], self.spans[-1][1]) if self.spans
                       else (0.0, 0.0))
        w0, w1 = self.window
        self.device = [(max(s, w0), min(e, w1), n) for s, e, n in device
                       if e > w0 and s < w1]
        self.host = host
        self.busy_merged = _merge((s, e) for s, e, _ in self.device)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_merged)

    def host_s(self):
        """Per request: its span less the device activity inside it."""
        return [(e - s) - _overlap(self.busy_merged, s, e)
                for s, e in self.spans]

    def kernel_s(self, pattern: re.Pattern) -> float:
        """Device time of the kernels whose name matches ``pattern``."""
        return sum(e - s for s, e, n in self.device if pattern.search(n))

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds]]."""
        total = {}
        for s, e, n in self.device:
            total[n] = total.get(n, 0.0) + (e - s)
        return [[n[:160], t] for n, t in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The longest idle gaps of the card in the window, each named by
        the innermost host operation that covers most of it."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy_merged for x in iv] + [w1]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            cover = [(min(e, b) - max(s, a), b - a, n) for a, b, n in self.host
                     if a < e and b > s and not n.startswith("bench.")]
            name = "host (no traced operation)"
            if cover:
                most = max(c[0] for c in cover)
                # the shortest operation among those covering most of it
                name = min((c for c in cover if c[0] >= 0.5 * most),
                           key=lambda c: c[1])[2]
            out.append([name[:160], e - s])
        return out


def _kineto_events(prof):
    """(device, host, spans) from the profiler's kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            start, length = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:
            start, length = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        end = start + length
        name = ev.name()
        if ev.device_type() == cuda:
            # the card's mirror of a host span covers work, it is none
            if not name.startswith("bench."):
                device.append((start, end, name))
        elif name == SPAN:
            spans.append((start, end))
        else:
            host.append((start, end, name))
    return device, host, spans


class Tracer:
    """Profiles the window when ``on``; a no-op otherwise."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str = SPAN):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def reduce(self) -> Trace | None:
        if self.prof is None:
            return None
        return Trace(*_kineto_events(self.prof))

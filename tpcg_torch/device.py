"""The port's rule for a device the caller does not name, and its copies
between host and device.

The entry points (``tpcg_torch.cg``, ``cg_matrix`` for a scipy matrix), the
problem constructors, the sparse containers' constructors
(``DiaMatrix.from_scipy``, ``EllMatrix.from_scipy``,
``EllMatrix.from_csr_arrays``, ``to_device_matrix``) and ``ops.cplx.to_planes``
run on the CUDA device unless the caller names another one; the CPU runs only
when asked for (``device="cpu"``).  Without a card the default raises:
nothing picks the CPU silently.

A call's copies from host to device go through :func:`upload`, its copies
back through :func:`download`: each is a span of ``tpcg_torch.trace``
(``tpcg.upload``, ``tpcg.download``), and the bytes copied count in
``h2d_bytes`` and ``d2h_bytes``.  Both copies are blocking, so each waits
for the work queued on the card before it; that wait is done first, in a
span of its own (:func:`wait`, ``tpcg.wait``), so that a copy's span holds
the copy alone.  Where nothing crosses devices (the CPU path) they are
plain ``.to`` and ``.numpy()``, with no span and no count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import trace


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; ``None`` means the current CUDA device,
    and raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the default device is the card; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def upload(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``t.to(device, dtype)``; from host memory to a device, after
    :func:`wait`, in span ``tpcg.upload``, counting the bytes that land in
    ``h2d_bytes`` (a blocking copy converts the dtype on the host)."""
    device = torch.device(device)
    if t.device.type != "cpu" or device.type == "cpu":
        return t.to(device, dtype)
    wait(device)
    with trace.span("upload"):
        out = t.to(device, dtype)
        trace.count("h2d_bytes", out.nbytes)
    return out


def wait(device) -> None:
    """The host waits for the work queued on the device's current stream,
    in span ``tpcg.wait``; nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with trace.span("wait"):
        torch.cuda.current_stream(device).synchronize()


def download(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array in host memory; from a device, in span
    ``tpcg.download``, counting its bytes in ``d2h_bytes`` (call
    :func:`wait` first, once for the results of a call)."""
    if t.device.type == "cpu":
        return t.numpy()
    with trace.span("download"):
        out = t.cpu()
        trace.count("d2h_bytes", out.nbytes)
    return out.numpy()

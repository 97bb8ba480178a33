"""The port's rule for a device the caller does not name.

The entry points (``tpcg_torch.cg``, ``cg_matrix`` for a scipy matrix), the
problem constructors, the sparse containers' constructors
(``DiaMatrix.from_scipy``, ``EllMatrix.from_scipy``,
``EllMatrix.from_csr_arrays``, ``to_device_matrix``) and ``ops.cplx.to_planes``
run on the CUDA device unless the caller names another one; the CPU runs only
when asked for (``device="cpu"``).  Without a card the default raises:
nothing picks the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; ``None`` means the current CUDA device,
    and raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the default device is the card; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())

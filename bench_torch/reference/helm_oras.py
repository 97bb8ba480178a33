"""Plain reference of the ``helm_oras`` class: the global FE Helmholtz
operator that the ORAS-FGMRES solve inverts, on the expanded N x N grid,
``S = K - (k^2 + i eps) M - i k B`` with ``eps = k^beta`` and impedance
parameter ``eta = k`` (``reference/helm_fe.py``'s element-by-element
operator on re/im planes; the reference's ``helm_fe(N, k, epsilon)``,
``p_h-PY_C-CL-multi-GPU.py:91-613``).  The comparison holds x against it
alone: nothing of the decomposition, the preconditioner or the program."""
from __future__ import annotations

from bench_torch.reference.helm_fe import HelmFE


def operator(cfg: dict, dtype, device) -> HelmFE:
    """The reference operator of a configuration of the ``helm_oras`` class."""
    return HelmFE(cfg["N"], cfg["k"], cfg["k"] ** cfg["beta"], dtype, device)

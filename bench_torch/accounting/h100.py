"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, at
its 700 W power limit) and the rule that turns a request's operations and
bytes into its least time on that card.

The bytes come from the problem, never from a kernel's layout, so the same
work reads the same whatever kernel implements it:

* working set (operator plus CG's state vectors x, r, d of every RHS) no
  larger than the L2: each input (operator, b) is read once and each output
  (x, the residual history) written once over the whole solve;
* larger than the L2: in every iteration the state vectors x, r and d of
  every RHS are read once and written once, and the operator's own data is
  read once.  Two grid-wide reductions hold each iteration apart from the
  next, so no iteration's state can stay on chip for the next.
"""
from __future__ import annotations

F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s
L2_BYTES = 50e6            # last-level cache, bytes
STATE_VECTORS = 3          # x, r, d


def request_bytes(acc, cfg: dict, n_rhs: int) -> float:
    """The bytes one request of ``n_rhs`` RHS must move, by the rule above;
    ``acc`` is the problem class's accounting module."""
    n, it, w = acc.n(cfg), cfg["n_iterations"], acc.ELEMENT_BYTES
    op = acc.operator_bytes(cfg)
    if op + STATE_VECTORS * w * n * n_rhs <= L2_BYTES:
        # b in, x and the float32 history out
        return op + 2 * w * n * n_rhs + 4 * (it + 1) * n_rhs
    return it * (op + 2 * STATE_VECTORS * w * n * n_rhs)


def request_ops(acc, cfg: dict, n_rhs: int) -> float:
    """Report Table II operations of one request: every iteration of every
    RHS."""
    return cfg["n_iterations"] * n_rhs * acc.ops_per_iteration(cfg)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of work on the card: the larger of the operations
    over the float32 peak and the bytes over the HBM peak."""
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)

"""One-level restricted additive Schwarz (ORAS) preconditioner (counterpart
of ``tpcg/parallel/schwarz.py``).

== ``as_prec`` (``p_h-PY_C-CL-multi-GPU.py:1837-2006``): solve every
subdomain's impedance block against the incoming residual, then run the
overlap exchange (RAS zeroing, overlap-add, averaging).

Only the reference's ``UseCG == 2`` is here: all subdomain blocks are the
one ``local_rect`` operator, so one batched solve with the subdomains as
its RHS (``p_h-PY_C-CL-multi-GPU.py:1919-1933``), ``CGMaxIT`` fixed COCG
iterations from x0 = 0.  The subdomain solver is kernel A complex
(``ops/stream_cg_dia.py::stream_cg_dia_rows_cplx``, ``csrc/stream_cg_dia.cu``)
on the block laid out once as a row-DIA matrix (7 diagonals): on a CUDA
tensor the kernel, every subdomain in one launch as thread-block clusters
side by side, on a CPU tensor its plain twin, the same recurrence in PyTorch (in float64 planes for a
complex128 state).  The kernel is float32, so on a card the state is
complex64; ``plan_hsolver`` refuses any other there.

**Departure from JAX's arithmetic.**  JAX sends the batched solve through
``fused_cg_stencil_chunked`` (``tpcg/parallel/schwarz.py:191-196``), whose
complex product is Karatsuba's ``[Ar, Ai, Ar+Ai]`` planes; the port's copy of
that kernel (``fused_cg.cu``) breaks down on some helm_fem directions
(ROADMAP queue 3 item 1).  Kernel A computes the same function (fixed-
iteration COCG, alpha and beta per RHS, a freeze guard) with the direct
four-multiply product.  Its freeze guard tests ``|delta|^2 == 0`` and holds
a frozen RHS until the next multiple of 256 iterations, where JAX's
``block_cg`` tests ``delta == 0`` each iteration; they part only once a RHS
converges exactly.

Spans and counters (``tpcg_torch.trace``): ``tpcg.precond`` around one
application (packing, the subdomain solve, unpacking, ``ol_update``);
``precond.applies`` counts applications, ``subsolve.rhs`` the subdomain RHS
solved.  The span waits for nothing: on a card it holds the host's side
of the application (the launches and the exchange's operations), while
the subdomain solve's device time is kernel A's in the profiler's trace.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import trace
from ..ops.stream_cg_dia import _stream_plain, stream_cg_dia_rows_cplx
from ..sparse import Stencil2D
from .halo import Decomposition


@dataclasses.dataclass
class SchwarzPrec:
    """z -> OL_update(P^{-1} z), batched over all subdomains.

    decomp        : Decomposition
    P             : the shared subdomain block, a complex Stencil2D of
                    (sdsz, sdsz) on the state's device, in the state's
                    dtype.
    cg_iterations : fixed COCG iterations (CGMaxIT, reference :3607).
    restricted, averaging : the ORAS flags (Restricted_AS, Averaging).
    """
    decomp: Decomposition
    P: Stencil2D
    cg_iterations: int = 256
    restricted: bool = True
    averaging: bool = True

    def __post_init__(self):
        # the block as row-DIA re/im planes (2, ndiag, n) in its own
        # precision, laid out once on its device
        dia = self.P.to_dia()
        self.offsets = tuple(int(o) for o in dia.offsets)
        self.values = torch.view_as_real(dia.data).movedim(-1, 0).contiguous()

    def subsolve(self, zb: torch.Tensor) -> torch.Tensor:
        """The batched subdomain solve: zb (2, nsubd, n) re/im planes ->
        x (2, nsubd, n), x0 = 0."""
        x0 = torch.zeros_like(zb)
        solve = stream_cg_dia_rows_cplx if zb.is_cuda else _stream_plain
        x, _ = solve(self.offsets, self.values, zb, x0, self.cg_iterations)
        trace.count("subsolve.rhs", zb.shape[1])
        return x

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        """z (M, M, S, S) complex -> the preconditioned correction, same
        shape."""
        shape = z.shape
        nsubd = shape[0] * shape[1]
        with trace.span("precond"):
            trace.count("precond.applies")
            zr = torch.view_as_real(z.reshape(nsubd, -1))
            x = self.subsolve(zr.permute(2, 0, 1).contiguous())
            r = torch.complex(x[0], x[1]).reshape(shape)
            return self.decomp.ol_update(r, restricted=self.restricted,
                                         averaging=self.averaging)

"""tpcg_torch -- the PyTorch and CUDA port of tpcg for NVIDIA Hopper.

The JAX package ``tpcg`` stays the reference; this package sits beside it,
mirrors its file names, and imports ``torch`` and never ``jax``.  Plain
tensor code is PyTorch; each Pallas kernel of ``tpcg`` becomes a kernel
written by hand for the H100 (``csrc/``), with a plain PyTorch version of
the same function beside it.
"""

from .cg import block_cg, cg_solve, udot, CGResult            # noqa: F401
from .api import cg, cg_matrix                                # noqa: F401
from .ops.auto import plan_stencil_cg, stencil_cg             # noqa: F401
from .ops.stream_cg import stream_cg_const                    # noqa: F401
from .ops.stream_cg_sym import stream_cg_sym                # noqa: F401
from .ops.stream_cg_coef import stream_cg_coef              # noqa: F401
from .sparse import (DiaMatrix, EllMatrix, Stencil2D,         # noqa: F401
                     to_device_matrix)
from .ops.route_spmv import DeviceRouted                     # noqa: F401
from .parallel import (hsolver, hsolve, plan_hsolver,         # noqa: F401
                       HSolverPlan)
from .utils.config import HelmholtzConfig                     # noqa: F401
from . import reference                                       # noqa: F401
from . import problems                                        # noqa: F401

__version__ = "0.1.0"

from .cplx import (to_planes, from_planes, cmul, cdiv, cabs,      # noqa: F401
                   udot_planes, PairOperator, make_pair_operator,
                   block_cg_planes, block_cg_planes_chunked,
                   CGPlanesResult)
from .fused_cg import (fused_cg, fused_cg_stencil,               # noqa: F401
                       fused_cg_stencil_chunked, fused_cg_stencil_plain,
                       prepare_coef3)
from .auto import plan_stencil_cg, stencil_cg, StencilCGPlan     # noqa: F401

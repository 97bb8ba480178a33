from .cplx import (to_planes, from_planes, cmul, cdiv, cabs,      # noqa: F401
                   udot_planes, PairOperator, make_pair_operator,
                   block_cg_planes, block_cg_planes_chunked,
                   CGPlanesResult)
from .fused_cg import (fused_cg, fused_cg_stencil,               # noqa: F401
                       fused_cg_stencil_chunked, fused_cg_stencil_plain,
                       prepare_coef3)
from .auto import plan_stencil_cg, stencil_cg, StencilCGPlan     # noqa: F401
from .stream_cg import (stream_cg_const, stream_cg_const_planes,  # noqa: F401
                        stream_cg_const_planes_plain,
                        stream_cg_const_planes_batched,
                        stream_cg_const_planes_batched_plain, prepare_stream,
                        apply_const_planes)
from .fused_cg_const import (fused_cg_const_planes,              # noqa: F401
                             fused_cg_const_planes_plain, prepare_const)
# stream_cg_real() is not re-exported here: it would hide its module
from .stream_cg_real import (stream_cg_real_planes,              # noqa: F401
                             stream_cg_real_coef_planes,
                             prepare_stream_real, prepare_stream_coef_real)
# stream_cg_sym() is not re-exported here: it would hide its module
from .stream_cg_sym import (stream_cg_sym_planes,                # noqa: F401
                            stream_cg_sym_planes_plain, prepare_stream_sym,
                            reconstruct_coef, apply_sym_planes)
# stream_cg_coef() is not re-exported here: it would hide its module
from .stream_cg_coef import (stream_cg_coef_planes,              # noqa: F401
                             stream_cg_coef_planes_plain,
                             stream_cg_coef_planes_batched,
                             stream_cg_coef_planes_batched_plain,
                             stream_cg_coef_planes_batched_fat,
                             stream_cg_coef_planes_batched_fat_plain,
                             prepare_stream_coef, apply_coef_planes)
# stream_cg_dia() itself is not re-exported: it would hide its module
from .stream_cg_dia import (stream_cg_dia_block,                 # noqa: F401
                            stream_cg_dia_cplx, stream_cg_dia_cplx_block,
                            dia_stream_fits, dia_stream_cplx_fits)
from .fused_cg_dia import (fused_cg_dia_cplx, fused_cg_dia_cplx_block,  # noqa: F401
                           fused_dia_cplx_fits)
from .route_spmv import (DeviceRouted, routed_matvec,           # noqa: F401
                         routed_matvec_block, routed_matvec_plain,
                         routed_pair)

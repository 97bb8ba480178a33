from .poisson import poisson                                  # noqa: F401
from .helmholtz import (assemble_helmholtz_fe, helm_fe,       # noqa: F401
                        helm_fe_var, local_rect)
from .rhs import (plane_wave_rhs, rhs_left_k2,                # noqa: F401
                  rhs_all_boundaries_k2, oshape_mask)
from .banded import banded_complex, banded_spd, parabolic_stencil  # noqa: F401

from .partition import Partition, make_partition                  # noqa: F401
from .halo import Decomposition                                   # noqa: F401
from .schwarz import SchwarzPrec                                  # noqa: F401
from .fgmres import fgmres, FGMRESResult                          # noqa: F401
from .hsolver import (hsolver, hsolve, plan_hsolver,              # noqa: F401
                      HSolverPlan, HSolverResult)

"""Configuration of the ORAS-FGMRES Helmholtz solver (counterpart of
``tpcg/utils/config.py``).

One dataclass in place of the reference's ~60 module-level globals and
their ``set_globals()`` reset (``p_h-PY_C-CL-multi-GPU.py:3508-3634``).
Field defaults are the reference's, with the source global named.  JAX's
TPU-only fields (``use_planes``, ``prec_kernel``, ``fgmres_chunk``,
``fgmres_chunk_split``) are not here: the port runs complex64 natively, one
Arnoldi step a host round trip, and its subdomain solver is chosen by the
device (``tpcg_torch.parallel.schwarz``).  Nor are the fields of modes the
port does not run (``cg_tol`` of UseCG 5, the island and Marmousi fields,
``inactive_mask``): the flags that select such modes raise
``NotImplementedError`` in ``plan_hsolver``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HelmholtzConfig:
    # problem (``__main__`` tail, :3639-3675)
    k: float = 20.0                  # kkk (:3608)
    beta: float = 1.0                # epsilon = k**beta (:3610, 3672)
    M_subd: int = 2                  # subdomains per side (argv M_s)
    W_subd: int = 16                 # subdomain width (argv W_s)
    OL: int = -1                     # overlap; -1 -> (W_subd-2)//2 (:3660)
    use_poisson: bool = False        # Use_Poisson (:3568)

    # preconditioner (as_prec)
    as_prec: int = 1                 # 0 none, 1 one-level AS (:3499-3504)
    robin: int = 1                   # 1 impedance blocks (:3671)
    restricted_as: bool = True       # Restricted_AS (:3583)
    averaging: int = 1               # Averaging (:3582)
    use_cg: int = 2                  # UseCG sub-solver mode (:3684)
    cg_max_it: int = 256             # CGMaxIT (:3607)
    eps_prec1: float = -1.0          # ep1; -1 -> epsilon (:3673)

    # Krylov (gmres dispatcher, :3294-3338)
    gmres_ver: str = "fgmres"        # GMRES_VER (:3541)
    tol: float = 1e-6                # Tol (:3443)
    restart: int = 600               # restrt (:3504)

    # variable-coefficient island (:3593-3605)
    var_coeff: bool = False          # VarCoeff
    use_marmousi: bool = False       # UseMarmousi

    # O-shape domain / inactive-node masking (:3603-3605)
    oshape_d: bool = False           # OshapeD (:3604)

    # run control
    guess: int = 1                   # 1 ones, 2 random, else zeros (:3474)
    verbose: int = 10                # (:3585)
    dtype: str = "complex64"         # device dtype (reference: csingle)
    seed: int = 0                    # for guess == 2

    @property
    def epsilon(self) -> float:
        return self.k ** self.beta

    @property
    def eps1(self) -> float:
        return self.epsilon if self.eps_prec1 < 0 else self.eps_prec1

    @property
    def overlap(self) -> int:
        return (self.W_subd - 2) // 2 if self.OL < 0 else self.OL

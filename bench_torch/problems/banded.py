"""The program's m_t1-class banded SPD matrix of a configuration:
``tpcg_torch.problems.banded_spd(n, half_band_diags, seed)``, put on the
run's device as the program's ``DiaMatrix`` in float32, as a caller who
solves many RHS on one matrix keeps it."""
from __future__ import annotations

import numpy as np


class Problem:
    def __init__(self, cfg: dict, device):
        from tpcg_torch import DiaMatrix
        from tpcg_torch.problems import banded_spd
        A = banded_spd(cfg["n"], cfg["half_band_diags"],
                       seed=cfg["matrix_seed"])
        self.dia = DiaMatrix.from_scipy(A, dtype=np.float32, device=device)


def build(cfg: dict, device) -> Problem:
    return Problem(cfg, device)

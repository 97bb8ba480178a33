"""The program's parabolic_fem stand-in of a configuration:
``tpcg_torch.problems.parabolic_stencil(Ng, diag=...)``, the 7-point FE
stencil on an Ng x Ng grid, float32 on the run's device, as a caller who
holds the grid operator keeps it."""
from __future__ import annotations


class Problem:
    def __init__(self, cfg: dict, device):
        from tpcg_torch.problems import parabolic_stencil
        self.grid = (cfg["Ng"], cfg["Ng"])
        self.stencil = parabolic_stencil(cfg["Ng"], device=device,
                                         diag=cfg["diag"])


def build(cfg: dict, device) -> Problem:
    return Problem(cfg, device)

"""The program's ORAS-FGMRES solver of a configuration:
``tpcg_torch.plan_hsolver`` on the run's device, set up once (the
decomposition, the cropped global operator and the subdomain block on the
device, x0 = ones)."""
from __future__ import annotations

# configuration keys that are HelmholtzConfig fields of the same name
FIELDS = ("k", "beta", "M_subd", "W_subd", "OL", "cg_max_it", "restart",
          "robin", "restricted_as", "averaging", "guess", "dtype")


class Problem:
    def __init__(self, cfg: dict, device):
        import tpcg_torch
        hcfg = tpcg_torch.HelmholtzConfig(use_cg=2, gmres_ver="fgmres",
                                          verbose=0,
                                          **{f: cfg[f] for f in FIELDS})
        self.plan = tpcg_torch.plan_hsolver(hcfg, device)
        part = self.plan.decomp.part
        # the program's partition keeps the reference's unique regions
        # (strict parity) always
        got = (part.N, part.OL, part.sdsz, True)
        want = (cfg["N"], cfg["OL"], cfg["sdsz"], cfg["strict_parity"])
        if got != want:
            raise ValueError(f"the partition has N, OL, sdsz, strict "
                             f"parity {got}, the configuration {want}")
        self.grid = (part.N, part.N)


def build(cfg: dict, device) -> Problem:
    return Problem(cfg, device)

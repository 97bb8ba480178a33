"""Standard-normal RHS drawn from the seed, with no two columns alike.

One float32 sequence of ``n_rhs n + pool * STRIDE`` standard normals is
drawn from the seed in set-up.  Request ``i`` takes ``n_rhs n`` of it,
starting ``STRIDE`` values after request ``i - 1``'s start.  STRIDE is a
prime above ``n_rhs`` that does not divide ``n``, so no column of any
request starts where another does, and ``pool`` requests pass before one
repeats.  ``pool[i]`` is a
view: (n_rhs, n) float32.
"""
from __future__ import annotations

import numpy as np

STRIDE = 7919


class Pool:
    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.n, self.nrhs = cfg["n"], traffic["n_rhs"]
        self.count = traffic["pool"]
        self.values = np.random.default_rng(seed).standard_normal(
            self.nrhs * self.n + self.count * STRIDE, dtype=np.float32)

    def __getitem__(self, i: int) -> np.ndarray:
        start = (i % self.count) * STRIDE
        return self.values[start:start + self.nrhs * self.n].reshape(
            self.nrhs, self.n)


def pool(cfg: dict, traffic: dict, seed: int) -> Pool:
    return Pool(cfg, traffic, seed)

"""tpcg_torch.problems == tpcg.problems, entry for entry."""
import numpy as np
import pytest

import tpcg.problems as jp
import tpcg_torch.problems as tp

_C = 0.5 + np.random.default_rng(0).random((8, 10))

STENCILS = {
    "helm_fe": lambda m: m.helm_fe(12, 5.0, eps=5.0),
    "helm_fe_eps": lambda m: m.helm_fe(9, 4.0, eps=1.5),
    "local_rect": lambda m: m.local_rect(10, 4.0, 2.0, 3.0, L=0.7,
                                         Nhoriz=7, Nvert=5),
    "helm_fe_var": lambda m: m.helm_fe_var(11, 6.0, _C, 0.1, Nhoriz=11,
                                           Nvert=9),
    "poisson": lambda m: m.poisson(8),
}

GRIDS = {
    "plane_wave_rhs": lambda m: m.plane_wave_rhs(12, 5.0),
    "plane_wave_rhs_dir": lambda m: m.plane_wave_rhs(9, 3.0,
                                                     direction=[0.6, 0.8]),
    "rhs_left_k2": lambda m: m.rhs_left_k2(7, 3.0),
    "rhs_all_boundaries_k2": lambda m: m.rhs_all_boundaries_k2(7, 3.0),
    "oshape_mask": lambda m: m.oshape_mask(12),
}


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_stencil_entry_for_entry(name):
    js, ts = STENCILS[name](jp), STENCILS[name](tp)
    assert ts.offsets == tuple(js.offsets)
    assert ts.grid == tuple(js.grid)
    assert ts.coef.device.type == "cpu"
    c = ts.coef.numpy()
    assert c.dtype == np.asarray(js.coef).dtype
    np.testing.assert_array_equal(c, np.asarray(js.coef))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_rhs_entry_for_entry(name):
    np.testing.assert_array_equal(GRIDS[name](tp), GRIDS[name](jp))

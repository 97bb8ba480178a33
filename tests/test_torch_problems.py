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


def _bench(name):
    """Load a benchmarks/ module by path (it imports JAX only inside its
    functions)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / name
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["banded_spd", "banded_complex",
                                   "parabolic"])
def test_fig5_standins_equal_the_benchmark_generators(which):
    """tpcg_torch.problems.banded copies the JAX benchmarks' generators of
    the banded Fig. 5 classes (at a reduced size here)."""
    import scipy.sparse as sp
    from tpcg_torch.problems import (banded_complex, banded_spd,
                                     parabolic_stencil)
    if which == "banded_spd":
        want = _bench("bench_general_sparse.py").banded_spd(3000, 6, seed=3)
        got = banded_spd(3000, 6, seed=3)
    elif which == "banded_complex":
        want = _bench("bench_fig5.py").banded_complex(500, range(0, 9),
                                                      seed=2)
        got = banded_complex(500, range(0, 9), seed=2)
    else:
        # bench_fig5.py:198-209 builds this stencil inline in main(): the
        # same offsets and coefficient planes, literally, at Ng = 9
        from tpcg.sparse import Stencil2D
        Ng = 9
        offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1),
                (-1, -1))
        coef = np.empty((7, Ng, Ng), np.float32)
        coef[0] = 8.0
        for s in range(1, 7):
            coef[s] = -1.0
        coef[1][:, -1] = 0; coef[2][:, 0] = 0
        coef[3][-1, :] = 0; coef[4][0, :] = 0
        coef[5][-1, :] = 0; coef[5][:, -1] = 0
        coef[6][0, :] = 0; coef[6][:, 0] = 0
        want = Stencil2D(offs, coef, (Ng, Ng)).to_scipy()
        S = parabolic_stencil(Ng)
        assert S.offsets == offs
        np.testing.assert_array_equal(S.coef.numpy(), coef)
        got = S.to_scipy()
        assert (got != got.T).nnz == 0
    assert got.shape == want.shape
    assert abs(sp.csr_matrix(got) - sp.csr_matrix(want)).max() == 0

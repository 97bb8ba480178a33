"""A run driven on the CPU with the timed path broken underneath comes out
not correct.

Each test skips the harness's look for a card (``run.measure`` on the CPU,
where the program runs its plain paths) at a small size, patches the
program's function that the cell's entry calls, and runs the rest of a
run: window, sample, comparison.  Faults a solve can have:

* ``unchanged``: the state is returned as it came in (x = x0 = 0);
* ``truncated``: the solve runs half the iterations asked for;
* ``half_batch``: half of a request's RHS are left unsolved;
* ``altered``: an answer is altered where it is produced (one RHS's x
  conjugated, or negated where it is real, as a slip in putting x
  together would).
"""
import dataclasses

import numpy as np
import pytest
import torch

from bench_torch import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(name):
    """The cell at its configuration's ``cpu_test`` sizes: small enough for
    the CPU, long enough that the solves converge."""
    cell = spec.cell(name)
    return dataclasses.replace(
        cell, config={**cell.config, **cell.config["cpu_test"]})


def _break(xv, fault):
    """Apply ``fault`` in place to x viewed as (n_rhs, ...)."""
    if fault == "unchanged":
        xv[:] = 0
    elif fault == "half_batch":
        xv[len(xv) // 2:] = 0
    elif np.iscomplexobj(xv):
        xv[0] = xv[0].conj()
    else:
        xv[0] = -xv[0]


def _patch(monkeypatch, cell, fault):
    import tpcg_torch
    nrhs = cell.traffic["n_rhs"]
    name = run._load("entries", cell.traffic["entry"]).Entry.CALLS
    orig = getattr(tpcg_torch, name)

    def call(*args, **kwargs):
        if fault == "truncated":
            kwargs["n_iterations"] //= 2
            return orig(*args, **kwargs)
        x, h = orig(*args, **kwargs)
        x = np.array(x)
        _break(x.reshape(nrhs, -1), fault)
        return x, h
    monkeypatch.setattr(tpcg_torch, name, call)


def _faults(name):
    nrhs = spec.cell(name).traffic["n_rhs"]
    return ["unchanged", "truncated", "altered"] + (
        ["half_batch"] if nrhs > 1 else [])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = run.measure(small(name), 2**32 + 3, 0.3, False,
                            torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name, fault",
                         [(n, f) for n in CELLS for f in _faults(n)])
def test_fault_is_refused(name, fault, monkeypatch):
    cell = small(name)
    _patch(monkeypatch, cell, fault)
    result, _ = run.measure(cell, 2**32 + 3, 0.3, False, torch.device("cpu"))
    assert not result["correct"], result["checks"]

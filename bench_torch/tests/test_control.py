"""The control, the plain reference put in the program's place and computed
in bfloat16 (the precision below the configurations' float32), comes out
not correct under every cell's limits.  On the CPU at a small size with the
sample a run checks; on the card at the cells' own sizes it is read by
``readings.py`` (PERF.md)."""
import pytest
import torch

from bench_torch import check, readings
from bench_torch.run import _load
from bench_torch.tests.test_faults import CELLS, small


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    cell = small(name)
    pool = _load("rhs", cell.traffic["rhs"]).pool(cell.config, cell.traffic,
                                                 2**31 + 11)
    dev = torch.device("cpu")
    numbers, _ = check.readings(cell, *readings.control_answers(cell, pool,
                                                                dev), dev)
    ok, _ = check.judge(cell, numbers)
    assert not ok, numbers

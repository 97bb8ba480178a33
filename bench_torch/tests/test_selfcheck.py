"""CPU self-checks of the benchmark's yardstick and of ``BENCHMARK.json``.

Run from the repo root: ``python -m pytest bench_torch/tests -q``.
"""
import importlib
import re
import subprocess
import sys

import pytest
import torch

from bench_torch import spec
from bench_torch.accounting import banded, h100, helm_fe

B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]
ONE_LINE = re.compile(r"[^\n\t]{1,200}")
HELM_FE_2048 = {"N": 2048, "n_iterations": 500}


def cfg(name):
    return spec.cell(next(w["name"] for w in B["workloads"]
                          if w["config"] == name)).config


def test_table_ii_operations():
    assert helm_fe.ops_per_iteration(cfg("helm_fem")) == 1_564_688
    assert helm_fe.ops_per_iteration(HELM_FE_2048) == 402_522_128
    assert banded.ops_per_iteration(cfg("m_t1")) == (2 * 9_761_028
                                                     + 10 * 97_578)


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_counts_match_the_config_files(name):
    c = cfg(name)
    acc = importlib.import_module(f"bench_torch.accounting.{c['problem']}")
    assert acc.n(c) == c["n"] and acc.nnz(c) == c["nnz"]


def test_state_floor_8_rhs_500_iterations():
    """PERF.md rows 10/11: 48 B a node and RHS an iteration, 240.39 ms."""
    nbytes = h100.request_bytes(helm_fe, HELM_FE_2048, 8)
    assert round(nbytes / h100.HBM_BYTES_PER_S * 1e3, 2) == 240.39
    ops = h100.request_ops(helm_fe, HELM_FE_2048, 8)
    assert h100.least_seconds(ops, nbytes) == nbytes / h100.HBM_BYTES_PER_S


def test_l2_resident_solve_is_operations_bound():
    c = cfg("helm_fem")
    ops = h100.request_ops(helm_fe, c, 1)
    nbytes = h100.request_bytes(helm_fe, c, 1)
    assert nbytes < 1e6
    assert round(h100.least_seconds(ops, nbytes) * 1e3, 3) == 0.117


def test_m_t1_block16_is_bytes_bound_past_the_l2():
    """Values 39.04 MB and x, r, d of 16 RHS 18.74 MB pass the 50 MB L2:
    every iteration reads the values once and the state once, and writes
    the state once."""
    c = cfg("m_t1")
    state = 3 * 4 * 97_578 * 16
    assert banded.operator_bytes(c) + state > h100.L2_BYTES
    nbytes = h100.request_bytes(banded, c, 16)
    assert nbytes == 5000 * (4 * 9_761_028 + 2 * state)
    ops = h100.request_ops(banded, c, 16)
    assert h100.least_seconds(ops, nbytes) == nbytes / h100.HBM_BYTES_PER_S


def test_names_units_and_lines():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in B["workloads"]]
             + [k for c in B["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.fullmatch(n), n
    for m in METRICS:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in B["workloads"]]
                 + [c["why"] for c in B["configs"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]] + B["command"]):
        assert ONE_LINE.fullmatch(text), text
    for group in (B["configs"], B["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)


def test_keys_as_the_contract_has_them():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_per_layer_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_enough():
    for name in CELLS:
        c = spec.cell(name)
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_check_budget_fits_with_24_cells():
    rs = B["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


def test_every_named_file_is_there():
    root = spec.BENCH_DIR
    for name in CELLS:
        c = spec.cell(name)
        for kind in ("problems", "reference", "accounting"):
            assert (root / kind / f"{c.problem}.py").is_file()
        assert (root / "entries" / f"{c.traffic['entry']}.py").is_file()
        assert (root / "rhs" / f"{c.traffic['rhs']}.py").is_file()
    for m in METRICS:
        assert hasattr(importlib.import_module(
            f"bench_torch.metrics.{m['name'].split('.')[0]}"), "read")
    for c in B["configs"]:
        assert c["file"].startswith("bench_torch/")
        assert spec.cell(next(w["name"] for w in B["workloads"]
                              if w["config"] == c["name"])).config[
            "name"] == c["name"]


def _sources(sub=""):
    """The harness's modules (the tests aside)."""
    return sorted(p for p in (spec.BENCH_DIR / sub).rglob("*.py")
                  if "tests" not in p.relative_to(spec.BENCH_DIR).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_nothing_imports_jax_or_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|tpcg)\b(?!_torch)",
                         text, re.M), path
    assert "bench.py" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", _sources("reference") + _sources("rhs")
                         + _sources("accounting")
                         + [spec.BENCH_DIR / "check.py"],
                         ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "tpcg_torch" not in path.read_text(), path


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""

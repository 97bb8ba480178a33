"""``BENCHMARK.json`` and the data files that it names.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

* configuration ``c``: ``bench_torch/configs/c.json`` (the ``file`` of its
  entry), whose ``problem`` names the problem class ``p``:
  ``problems/p.py`` builds the program's operator, ``reference/p.py`` is
  its plain reference, ``accounting/p.py`` counts its operations and bytes;
* traffic mix ``t``: ``bench_torch/traffic/t.json``, whose ``entry`` names
  ``entries/<entry>.py`` (the program's entry point that a request calls)
  and whose ``rhs`` names ``rhs/<rhs>.py`` (the generator of its pool);
* metric ``m`` or ``m.<kind>``: ``bench_torch/metrics/m.py``, a reader with
  ``read(ctx)`` (one quantity split by the kind of cell that reports it);
* cell ``w``: ``bench_torch/limits/w.json``, the limits of its comparison.
"""
from __future__ import annotations

import json
import pathlib
import re
from dataclasses import dataclass

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the data files it names."""
    name: str
    chips: int
    config: dict        # the configuration's file, as it is run
    traffic: dict       # the traffic mix's file
    limits: dict        # the cell's limits file
    end_to_end: list    # the metric entries this cell reports, --trace 0
    per_layer: list     # and --trace 1

    @property
    def problem(self) -> str:
        return self.config["problem"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError if none."""
    spec = spec or benchmark()
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    return Cell(
        name=name, chips=work["chips"],
        config=_load(ROOT / conf["file"]),
        traffic=_load(BENCH_DIR / "traffic" / f"{work['traffic']}.json"),
        limits=_load(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])

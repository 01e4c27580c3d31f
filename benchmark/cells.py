"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the file its ``configs`` entry names, under ``configs/``;
* a traffic mix: ``traffic/<traffic>.json``;
* a per-layer metric: ``metrics/<name>.py``, a module with
  ``read(trace) -> float | None`` (None: nothing to read in this run, and the
  metric is left out of the line), taken where its ``workloads`` list the
  cell or it has none. A dotted name reads its quantity's file
  (:func:`quantity`, as for end-to-end metrics): ``mfu.uhd``, listing a new
  cell, is ``metrics/mfu.py`` read in that cell;
* an end-to-end metric: what the harness measures under the metric's
  quantity, its name up to the first ``.`` (:func:`quantity`), so that
  ``out_fps.union`` is ``out_fps`` under a bound of its own.

Adding a cell, a configuration, a mix or a metric adds files and entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Cell:
    root: str
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple
    per_layer: tuple


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: run from a checkout of the repository")
    return _read_json(path)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    from benchmark import stream

    spec = bench_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = stream.load(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    return Cell(root, name, config, traffic, int(w["chips"]),
                tuple(m for m in spec["end_to_end"] if _applies(m, name)),
                tuple(m for m in spec["per_layer"] if _applies(m, name)))


def quantity(name: str) -> str:
    """What a metric named ``name`` measures: its name up to the first ``.``."""
    return name.split(".")[0]


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``metrics/<quantity(name)>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{quantity(name)}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read

"""Finding a cell's files by name.

A cell is its entry in ``BENCHMARK.json``'s ``workloads``, which names its
configuration and traffic mix; ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<config>.json`` hold them and the
comparison's limits;
``metrics/<metric>.py`` (or, for ``<quantity>.<suffix>``, the shared
``metrics/<quantity>.py``) is the reader of one metric.  Which metrics a
cell reports is ``BENCHMARK.json``'s: an end-to-end or per-layer metric
whose ``workloads`` list the cell, or that lists none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "benchmark", "cell", "load", "metric_reader", "reported"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {kind}/{name}.json under the benchmark's folder")
    return json.loads(path.read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    """The workload entry ``name`` of ``bench`` (``BENCHMARK.json``) with its
    configuration, traffic mix and limits filled in."""
    entries = {w["name"]: w for w in (benchmark() if bench is None else bench)["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = entries[name]
    return dict(c, config_spec=load("configs", c["config"]),
                traffic_spec=load("traffic", c["traffic"]), limits=load("limits", c["config"]))


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reported(bench: dict, section: str, cell_name: str) -> list[dict]:
    """The entries of ``bench[section]`` that ``cell_name`` reports."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """The ``read(ctx)`` function of a metric's reader file."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} under metrics/")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""Everything of a cell, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix, its limits and the readers of
its per-layer metrics.

A cell names a configuration and a traffic mix; the configuration's entry
names its file; the mix is ``perfbench/traffic/<traffic>.json``; the
limits of the numbers its check compares are ``perfbench/limits/<cell>
.json``; a per-layer metric ``<name>`` is read by
``perfbench/metrics/<name>.py``'s ``read``.  A metric with a
``"workloads"`` list belongs to those cells only.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Dict:
    """The cell ``name`` with its configuration, traffic, limits and
    metric lists."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return dict(
        name=name, chips=int(cell["chips"]), config_name=conf["name"],
        config=load_json(ROOT / conf["file"]),
        traffic_name=cell["traffic"],
        traffic=load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> Callable:
    """``read(run) -> value or None`` of per-layer metric ``name``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""Everything of a cell, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its architecture's module, its traffic mix, its
limits and the readers of its per-layer metrics.

A cell names a configuration and a traffic mix; the configuration's entry
names its file; the file's ``"reference"`` names, from the checkout's
root, the module of its architecture (``perfbench/run.py``, "Adding");
the mix is ``perfbench/traffic/<traffic>.json``; the limits of the
numbers its check compares are ``perfbench/limits/<cell>.json``; a
per-layer metric ``<name>`` is read by ``perfbench/metrics/<name>.py``'s
``read``.  A metric with a ``"workloads"`` list belongs to those cells
only.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def merged(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s entries in place of its own, nested dicts
    merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch_module(config: Dict, where: str) -> ModuleType:
    """The module of a configuration's architecture, loaded from the path
    its ``"reference"`` gives; ``where`` names the configuration in the
    errors."""
    rel = config.get("reference")
    if not rel:
        raise KeyError(f"{where} has no \"reference\": the path, from the "
                       f"checkout's root, of its architecture's module")
    path = ROOT / rel
    if not path.is_file():
        raise FileNotFoundError(f"{where} names the architecture module "
                                f"{rel!r}, and {path} is no file")
    return _load_module(path, "perfbench_arch_" + "".join(
        c if c.isalnum() else "_" for c in rel))


def load_cell(name: str, override: Optional[Dict] = None) -> Dict:
    """The cell ``name`` with its configuration, architecture's module
    (``"arch_module"``), traffic, limits and metric lists.  ``override`` (CPU
    tests only) replaces parts of the cell's files before the module is
    loaded."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    out = dict(
        name=name, chips=int(cell["chips"]), config_name=conf["name"],
        config=load_json(ROOT / conf["file"]),
        traffic_name=cell["traffic"],
        traffic=load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
    if override:
        out = merged(out, override)
    out["arch_module"] = arch_module(out["config"], conf["file"])
    return out


def metric_reader(name: str) -> Callable:
    """``read(run) -> value or None`` of per-layer metric ``name``."""
    return _load_module(
        BENCH_DIR / "metrics" / f"{name}.py",
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_")).read

"""The benchmark's files, found by name, and ``BENCHMARK.json`` against
the contract's shape: names, units, lengths, one reader per per-layer
metric, a configuration file, a traffic mix and limits per cell, and the
check's time budget."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import bench  # noqa: E402

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_budget_at_24_cells():
    R = B["run_seconds"]
    assert (2 + 14 * 24) * (R + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_metrics_keys_and_bounds():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            assert w in CELLS


def test_roofline_and_mfu_names():
    names = [m["name"] for m in B["per_layer"]]
    assert "step_mfu" in names
    for n in names:
        if "roofline" in n:
            assert n.endswith("_roofline")
            m = next(x for x in B["per_layer"] if x["name"] == n)
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_lookup(cell):
    c = bench.load_cell(cell)
    assert c["chips"] == 1
    assert c["config"]["model"]["n_layers"] == 30
    assert c["traffic"]["runtime"]["kind"] in ("epoch", "continuous")
    assert c["limits"]["gap_max"]["limit"] > 0
    e2e = {m["name"] for m in c["end_to_end"]}
    assert {"setup_s", "tokens_per_s", "request_p95_ms"} <= e2e
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))


@pytest.mark.parametrize("conf", B["configs"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("perfbench/")
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    assert [c["file"] for c in B["configs"]].count(conf["file"]) == 1
    assert any(w["config"] == conf["name"] for w in B["workloads"])


def test_configs_are_the_programs():
    from perfbench.harness.runner import port_config
    for conf in B["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        mod = bench.arch_module(data, conf["file"])
        cfg = port_config(mod, data["model"], data["arch"], reduced=False)
        assert cfg.arch_id == data["arch"]


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()

"""Whole runs of the harness on the CPU at a reduced size: the result
line's shape, and ``correct`` coming out false when the served path is
broken underneath.

These runs skip the harness's look for a card (``run_cell`` is called
with ``device="cpu"``); their numbers are CPU numbers and go out under
``cpu.``-prefixed names, never under a device metric's.  The limit of
the widest gap is the reduced size's own: sound runs read at most
0.0014 there, each fault below at least 0.09 (readings on three seeds,
a reduced BLOOM-3B, bf16), so 0.02 separates them.  The faults: a
decode step that leaves the cache as it found it (its state returned
unchanged); half of the batch left out (the other half's logits served
in its place); a token altered where it is produced (every row's token
at one decode step); the prompts laid out wrongly (each row's tokens
reversed where the program pads them: the reference pads the raw prompt
itself, so the check sees it).  One card has no exchange between chips
to leave out.  The checked sample holds a row of every batch slot, so a fault in
half of every batch cannot slip past it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

torch.set_num_threads(1)

TINY_LIMIT = 0.02


def tiny(limit=TINY_LIMIT):
    return {"config": {"model": {"n_layers": 2, "d_model": 64,
                                 "n_heads": 4, "n_kv_heads": 4,
                                 "d_head": 16, "d_ff": 256, "vocab": 512},
                       "engine": {"s_max": 32, "n_max": 8}},
            "traffic": {"runtime": {"k": 4, "arena": {"block_tokens": 8,
                                                      "shrink": 0.5}}},
            "limits": {"gap_max": {"limit": limit}}}


def _run(cell, seed=2 ** 31 + 3, seconds=1.0, trace=False):
    from perfbench.harness.runner import run_cell
    return run_cell(cell, seed, seconds, trace, time.perf_counter(),
                    device="cpu", override=tiny())


@pytest.mark.parametrize("cell", ["bloom3b-w8a16-epoch",
                                  "bloom3b-w8a16-continuous"])
def test_result_line_shape_cpu(cell):
    r = _run(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {"cpu.tokens_per_s", "cpu.request_p95_ms",
                                 "cpu.setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["checks"]["gap_max"]["value"] <= TINY_LIMIT
    json.dumps(r)


def test_traced_run_on_cpu_reports_no_device_metric():
    r = _run("bloom3b-w8a16-continuous", trace=True)
    names = set(r["metrics"])
    assert names and all(n.startswith("cpu.") for n in names)
    assert not any("roofline" in n or "idle" in n for n in names)
    assert "cpu.kv_pages_peak_share" in names
    assert "breakdown" not in r


def _unchanged_state(orig):
    def step(cfg, params, cache, tokens, pos, use_kernel=True):
        saved = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        out = orig(cfg, params, cache, tokens, pos, use_kernel)
        for layer, old in zip(cache, saved):
            for k in layer:
                layer[k].copy_(old[k])
        return out
    return step


def _half_batch(orig):
    def step(cfg, params, cache, tokens, pos, use_kernel=True):
        logits, cache = orig(cfg, params, cache, tokens, pos, use_kernel)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h]
        return logits, cache
    return step


def _altered_token(orig):
    def model_step(self, state):
        step = orig(self, state)

        def run(tokens, pos):
            out = step(tokens, pos)
            return torch.where(pos == self.s_max + 1,
                               (out + 1) % self.cfg.vocab, out)
        return run
    return model_step


def _reversed_prompts(orig):
    def pad_prompts(self, prompts):
        return np.ascontiguousarray(orig(self, prompts)[:, ::-1])
    return pad_prompts


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_token", "prompt_layout"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    if fault == "prompt_layout":
        monkeypatch.setattr(ServingEngine, "pad_prompts",
                            _reversed_prompts(ServingEngine.pad_prompts))
    elif fault == "altered_token":
        monkeypatch.setattr(ServingEngine, "_model_step",
                            _altered_token(ServingEngine._model_step))
    else:
        wrap = _unchanged_state if fault == "unchanged_state" \
            else _half_batch
        monkeypatch.setattr(transformer, "decode_step",
                            wrap(transformer.decode_step))
    r = _run("bloom3b-w8a16-epoch")
    assert r["correct"] is False
    assert r["checks"]["gap_max"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("cell", ["bloom3b-w8a16-epoch",
                                  "bloom3b-w8a16-continuous"])
def test_control_fails_where_the_program_passes(cell):
    """The control (the reference at int4 weights in the program's place,
    ``perfbench/control.py``), judged as the program is, comes out not
    correct on the same sample that the program passes."""
    from perfbench.harness.check import control_verdict
    from perfbench.harness.runner import run_cell
    keep = {}
    r = run_cell(cell, 2 ** 31 + 21, 1.0, False, time.perf_counter(),
                 device="cpu", override=tiny(), keep=keep)
    assert r["correct"] is True
    ctrl = control_verdict(keep)
    assert ctrl["correct"] is False
    assert ctrl["worst"] > TINY_LIMIT and ctrl["failed"] > 0


def test_sample_holds_the_longest_and_every_slot():
    from perfbench.harness.check import sample_rows
    rows = [dict(tokens=[1] * (3 + (i == 17)), slot=i % 8) for i in range(40)]
    for seed in (1, 2 ** 31 + 11):
        got = sample_rows(rows, 8, seed)
        assert got[0] is rows[17]
        assert sorted(r["slot"] for r in got) == list(range(8))
    assert len(sample_rows(rows[:3], 8, 5)) == 3


def _main(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "perfbench/run.py"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "bloom3b-w8a16-epoch", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    p = _main(ARGS, ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _main(ARGS, tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()

"""The Zamba2-7B-Instruct cell reduced, on the CPU: a whole run through
``run_cell`` is correct, the int4 control is not, and the two faults
the check has to catch (a decode step that leaves the SSM state
unchanged, a site whose decode step skips its KV write) come out not
correct; the three new per-layer metrics on hand-made records.

The reduced cell keeps every kind of part (9 Mamba2 layers, sites before
layers 2, 5 and 8, two blocks, two B/C groups, a conv bias, an adapter
and a linear per site) at small widths, bf16 as served, W8A16.  Its
limit is this size's own: sound runs read at most 0.019 on five seeds
(these two among them), the control at least 0.44, and each fault at
least 0.116 on three, so 0.06 separates them."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import bench  # noqa: E402

torch.set_num_threads(1)

CELL = "zamba2-7b-instruct-w8a16-epoch"
LIMIT = 0.06
SEEDS = [2 ** 31 + 3, 3_000_000_019]


def reduced():
    return {"config": {"model": {
                "n_layers": 9, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                "d_head": 32, "d_ff": 96, "vocab": 512,
                "ssm": {"d_state": 8, "head_dim": 16, "chunk": 8},
                "hybrid": {"sites": [2, 5, 8], "adapter_rank": 4}},
                "engine": {"s_max": 32, "n_max": 8}},
            "limits": {"gap_max": {"limit": LIMIT}}}


def _run(seed, keep=None):
    from perfbench.harness.runner import run_cell
    return run_cell(CELL, seed, 1.0, False, time.perf_counter(),
                    device="cpu", override=reduced(), keep=keep)


def test_cell_files():
    b = bench.benchmark()
    cell = bench.load_cell(CELL)
    conf = cell["config"]
    assert cell["traffic_name"] == "paper-r40-epoch" and cell["chips"] == 1
    assert conf["reduced"] == [] and conf["arch"] == "zamba2-7b-instruct"
    entry = {c["name"]: c for c in b["configs"]}["zamba2-7b-instruct"]
    assert entry["reduced"] == [] and entry["source"] == conf["source"]
    # every number of the published config.json is in the file, as given
    catalog = {"hidden_size": 3584, "num_hidden_layers": 81,
               "mamba_ngroups": 2, "n_mamba_heads": 112, "adapter_rank": 128,
               "attention_head_dim": 224, "chunk_size": 256,
               "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77]}
    for k, v in catalog.items():
        assert conf[k] == v, k
    assert conf["model"]["hybrid"]["sites"] == conf["hybrid_layer_ids"]
    # the model at its full published depth, as the cell is looked up
    assert conf["model"]["n_layers"] == conf["num_hidden_layers"] == 81
    assert cell["traffic"]["runtime"]["kind"] == "epoch"
    assert cell["limits"]["gap_max"]["limit"] > 0
    assert {"setup_s", "tokens_per_s", "request_p95_ms"} <= {
        m["name"] for m in cell["end_to_end"]}
    for m in cell["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))
    names = {m["name"] for m in cell["per_layer"]}
    assert {"mamba_prefill_share", "shared_block_prefill_share",
            "zamba2_step_roofline", "mamba2_decode_roofline", "graph_nodes",
            "decode_step_ms", "device_idle_share"} <= names
    assert not names & {"k1_gemv_roofline", "k4_roofline", "qmm_tc_roofline"}


@pytest.mark.parametrize("seed", SEEDS)
def test_reduced_cell_is_correct_and_its_control_is_not(seed):
    from perfbench.harness.check import control_verdict
    keep = {}
    r = _run(seed, keep)
    assert r["correct"] is True and r["attempted"] > 0
    assert r["checks"]["gap_max"]["value"] <= LIMIT
    assert {row["bits"] for row in keep["sample"]} == {8}
    ctrl = control_verdict(keep)
    assert ctrl["correct"] is False and ctrl["worst"] > LIMIT


def _unchanged_ssm(orig):
    def step(cfg, params, cache, tokens, pos):
        saved = [layer["ssm"].clone() if "ssm" in layer else None
                 for layer in cache]
        out = orig(cfg, params, cache, tokens, pos)
        for layer, old in zip(cache, saved):
            if old is not None:
                layer["ssm"].copy_(old)
        return out
    return step


def _skipped_kv_write(orig):
    """The first site's decode attention with its k, v write undone
    after the step (the attention itself saw the token's k, v)."""
    calls = []

    def attention(p, cfg, x, cache_k, cache_v, pos, use_rope=True,
                  scale=None, glue=False):
        calls.append(1)
        first = len(calls) % len(cfg.hybrid.sites) == 1
        saved = (cache_k.clone(), cache_v.clone()) if first else None
        out = orig(p, cfg, x, cache_k, cache_v, pos, use_rope, scale, glue)
        if saved is not None:
            cache_k.copy_(saved[0])
            cache_v.copy_(saved[1])
        return out
    return attention


@pytest.mark.parametrize("fault", ["unchanged_ssm_state", "skipped_kv_write"])
def test_faults_are_not_correct(fault, monkeypatch):
    from repro_torch.models import common, zamba
    if fault == "unchanged_ssm_state":
        monkeypatch.setattr(zamba, "decode_step",
                            _unchanged_ssm(zamba.decode_step))
    else:
        monkeypatch.setattr(common, "decode_attention_plain",
                            _skipped_kv_write(common.decode_attention_plain))
    r = _run(SEEDS[0])
    assert r["correct"] is False
    assert r["checks"]["gap_max"]["value"] > LIMIT


def test_reference_flops_count_the_published_model():
    """The FLOPs of one generated token at context c, counted by hand:
    the Mamba2 projections, the 13 sites' projections from the 7168-wide
    concatenation, o_proj, GeGLU, adapter and linear, the tied
    unembedding, the recurrence and the sites' attention."""
    conf = bench.load_cell(CELL)
    mod, model = conf["arch_module"], conf["config"]["model"]
    c = 600
    macs = (81 * (3584 * 14704 + 7168 * 3584)
            + 13 * (3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
                    + 128 * (3584 + 28672) + 3584 * 3584)
            + 32000 * 3584)
    want = 2 * macs + 81 * 4 * 112 * 64 * 64 + 13 * 4 * 32 * 224 * c
    assert mod.tokens_flops(model, c - 1, 1, 2) == want
    assert mod.prompt_flops(model, 1) == want - 13 * 4 * 32 * 224 * (c - 1)


# -- the new per-layer metrics -----------------------------------------------

def _window(intervals, calls):
    from perfbench.harness import program_trace

    class W(program_trace.Window):
        def __init__(self):
            self.pieces = [(0.0, 100.0)]
            self.intervals = [SimpleNamespace(name=n, t0=a, t1=b)
                              for n, a, b in intervals]
            self._calls = calls

        def calls(self):
            return self._calls
    return W()


def test_prefill_shares_read_the_nested_intervals(monkeypatch):
    from perfbench.harness import program_trace
    ivs = [("dev.prefill", 1.0, 2.0), ("dev.prefill.mamba", 1.1, 1.6),
           ("dev.prefill.shared", 1.6, 1.9), ("dev.prefill", 3.0, 4.0),
           ("dev.prefill.mamba", 3.0, 3.3), ("dev.decode", 2.0, 3.0)]
    mods = {}
    for name in ("mamba_prefill_share", "shared_block_prefill_share"):
        mods[name] = bench._load_module(
            ROOT / "perfbench" / "metrics" / f"{name}.py", "m_" + name)
        monkeypatch.setattr(mods[name], "window",
                            lambda run: _window(ivs, []))
    assert mods["mamba_prefill_share"].read(None) == pytest.approx(40.0)
    assert mods["shared_block_prefill_share"].read(None) == \
        pytest.approx(15.0)
    for name in mods:      # a program with no such interval: nothing
        monkeypatch.setattr(mods[name], "window",
                            lambda run: _window(ivs[:1], []))
        assert mods[name].read(None) is None
    assert program_trace.window is not None


def test_step_roofline_needs_the_programs_state_bytes(monkeypatch):
    from perfbench.costs import zamba2_step
    mod = bench._load_module(ROOT / "perfbench/metrics/"
                             "zamba2_step_roofline.py", "m_roof")
    cell = bench.load_cell(CELL)
    model, eng = cell["config"]["model"], cell["config"]["engine"]
    B = eng["batch_capacity"]
    calls = [dict(iters=2, dev={"dev.decode": 0.1})]
    monkeypatch.setattr(mod, "window", lambda run: _window([], calls))
    state = zamba2_step.state_bytes(model, B)
    run = SimpleNamespace(model=model, engine=eng, engine_info=dict(
        captures=[dict(nodes=5000, ssm_state_bytes=state)]))
    least = sum(max(o / 989e12, b / 3.35e12) for o, b in (
        zamba2_step.cost(model, B, 513), zamba2_step.cost(model, B, 514)))
    assert mod.read(run) == pytest.approx(100 * least / 0.1)
    # the hand count: 11.03 GB of int8 weights, 2.38 GB of float32 SSM
    # state read and written at B = 8, 1.72 GB of KV at a valid length
    # of 576: about 4.5 ms a step
    assert zamba2_step.weight_bytes(model) == pytest.approx(11.03e9,
                                                            rel=1e-3)
    assert 2 * 81 * 8 * 112 * 64 * 64 * 4 < state < 2.5e9
    ops, nbytes = zamba2_step.cost(model, B, 576)
    assert nbytes / 3.35e12 == pytest.approx(4.53e-3, rel=1e-2)
    for caps in ([], [dict(nodes=5000)],            # the parent's program
                 [dict(nodes=5000, ssm_state_bytes=state + 1)]):
        run.engine_info = dict(captures=caps)
        assert mod.read(run) is None


def test_engine_counts_the_state_bytes_it_captures():
    """The program's count equals the cost file's at the cell's shape:
    twice the bytes of every SSM and conv state leaf of the cohort."""
    from perfbench.costs import zamba2_step
    from repro_torch.config import get_arch
    from repro_torch.models import zamba
    cfg = get_arch("zamba2-7b-instruct")
    model = bench.load_cell(CELL)["config"]["model"]
    cache = zamba.init_cache(cfg, 8, 640, "meta")
    n = 2 * sum(leaf.nbytes for layer in cache for k, leaf in layer.items()
                if k in ("ssm", "conv"))
    assert n == zamba2_step.state_bytes(model, 8)
    assert sum(1 for layer in cache if "k" in layer) == 13
    json.dumps(n)


def test_kernel_roofline_counts_a_call_a_layer_and_step():
    """``mamba2_decode_roofline``: the sub-window's decode steps times the
    81 layers, each call's least time from ``costs/mamba2_decode.py``,
    over the kernels' traced time; where the profiler dropped records (at
    most half the calls, the two kernels' counts within one), the share
    over the whole calls the trace holds; no share where the trace falls
    further short."""
    from perfbench.costs import mamba2_decode
    cell = bench.load_cell(CELL)
    model, eng = cell["config"]["model"], cell["config"]["engine"]
    read = bench.metric_reader("mamba2_decode_roofline")
    ops, nb = mamba2_decode.cost(8, 112, 64, 64, 2, 4)
    assert nb == 2 * 8 * 112 * 64 * 64 * 4 + 2 * 8 * (7168 + 7424 + 112) \
        + 2 * 2 * 8 * 3 * 7424 + 2 * 5 * 7424 + 12 * 112 + 2 * 7168 \
        + 2 * 8 * 7168
    steps = 3
    kernels = [("void mamba2_scan_step_kernel<bf16>", 0, 6000),
               ("void mamba2_gate_norm_kernel<bf16>", 0, 1000)] * (81 * steps)
    run = SimpleNamespace(model=model, engine=eng, kernels=kernels,
                          profiled=[dict(steps=[(0, steps)], captures=0)])
    run.kernel_time_s = lambda pats: (
        sum(b - a for n, a, b in kernels if any(p in n for p in pats))
        * 1e-9, {p: sum(p in n for n, _, _ in kernels) for p in pats})
    least = 81 * steps * max(ops / 989e12, nb / 3.35e12)
    assert read(run) == pytest.approx(100 * least / (81 * steps * 7e-6))
    whole = kernels
    kernels = whole[:-3]        # the last gate, scan and gate dropped
    held = 81 * steps - 2
    assert read(run) == pytest.approx(
        100 * least * held / (81 * steps) / (held * 7e-6 + 6e-6))
    kernels = whole[:-2 * 81]   # a whole step dropped
    assert read(run) == pytest.approx(100 * least / (81 * steps * 7e-6))
    kernels = whole[:-3] + whole[-2:-1]     # two gates, no scan missing
    assert read(run) is None
    kernels = whole
    run.profiled = [dict(steps=[(0, 2 * steps + 1)], captures=0)]
    assert read(run) is None

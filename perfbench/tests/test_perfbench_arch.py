"""The cell's architecture as data: the harness takes the weights, the
float32 reference, the model FLOPs and the configuration mapping from
the module that the configuration file's ``"reference"`` names, and the
check judges each served row at the precision its call served it at.

BLOOM's module reads, to the bit, what the harness read before its
functions moved into it: the frozen digests and counts below were taken
once, at the tiny size on the CPU, from the functions of the commit
before the move (``perfbench/harness/weights.py:make_params``,
``perfbench/reference/bloom.py:forward_rows`` at one precision for all
rows, ``perfbench/costs/model_flops.py``), run from a ``git archive``
of that commit."""
from __future__ import annotations

import copy
import hashlib
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import bench  # noqa: E402
from perfbench.reference import bloom  # noqa: E402

torch.set_num_threads(1)

STUB = "perfbench/tests/arch_stub.py"
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
            d_ff=256, vocab=512, norm="layernorm", act="gelu",
            tie_embeddings=True, rope_theta=10000.0, dtype="bfloat16")
# the parent commit's readings (module docstring)
FROZEN_PARAMS = {2 ** 31 + 5: "b75b3b19a80e9309",
                 3_000_000_019: "9def25e560dcd2ef"}
FROZEN_LOGITS = {(2 ** 31 + 5, 8): "8a3fff030459d2f2",
                 (2 ** 31 + 5, 4): "1c1f03b4cd49d4e9",
                 (2 ** 31 + 5, 0): "a94b005773bbf494",
                 (3_000_000_019, 8): "e0001c7793984b30",
                 (3_000_000_019, 4): "12e4ae26c6ddfca0",
                 (3_000_000_019, 0): "c3eeb7c957e70c2c"}
FLOP_ARGS = ([(s,) for s in (1, 128, 512)],
             [(128, 0, 1), (128, 0, 128), (512, 5, 77), (256, 64, 128)])
FROZEN_FLOPS = {
    "tiny": [262656, 29458432, 167968768, 0, 45776896, 39241728, 28295168],
    "bloom-3b": [6003404800, 607800524800, 2457547571200, 0, 769884160000,
                 444443443200, 391109017600],
    "bloom-7b1": [14135296000, 1552301424640, 6251358453760, 0,
                  1807105392640, 1037258588160, 915684720640]}


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _leaves(p):
    out = [p["embed"]]
    for lp in p["layers"]:
        out += [lp["attn"][k] for k in ("wq", "wk", "wv", "wo")]
        out += [lp["norm1"], lp["norm2"], lp["ffn"]["w1"], lp["ffn"]["w2"]]
    return out + [p["final_norm"]]


def _rows(bits):
    """Three rows at s_max 16: a short prompt, a full one with nothing
    fed, a truncated one admitted at gap 3."""
    g = torch.Generator().manual_seed(11)
    out = []
    for n, gap, nf in ((5, 0, 4), (16, 0, 0), (23, 3, 6)):
        out.append(dict(
            prompt=torch.randint(1, 512, (n,), generator=g).tolist(),
            gap=gap, fed=torch.randint(1, 512, (nf,), generator=g).tolist(),
            bits=bits))
    return out


def _tiny(reference=None, **more):
    from test_perfbench_run import tiny
    over = tiny()
    if reference:
        over["config"]["reference"] = reference
    return bench.merged(over, more)


# -- the dispatch ------------------------------------------------------------

@pytest.mark.parametrize("cell", ["bloom3b-w8a16-epoch",
                                  "bloom3b-w8a16-continuous"])
def test_run_goes_through_the_configured_module(cell):
    """A CPU run whose configuration names the stub module takes the
    weights, the reference, the FLOPs and the configuration mapping from
    it, and is correct."""
    from perfbench.harness.runner import run_cell
    keep = {}
    r = run_cell(cell, 2 ** 31 + 13, 1.0, False, time.perf_counter(),
                 device="cpu", override=_tiny(STUB), keep=keep)
    stub = keep["arch_module"]
    assert Path(stub.__file__).resolve() == ROOT / STUB
    assert r["correct"] is True
    assert set(stub.CALLS) == {"file_sizes", "program_sizes",
                               "scaled_program", "make_params",
                               "forward_rows", "prompt_flops",
                               "tokens_flops"}
    assert stub.CALLS["make_params"] == stub.CALLS["forward_rows"] == 1


@pytest.mark.parametrize("fault", ["no_key", "missing_file"])
def test_config_without_its_module_fails_at_load(fault, tmp_path,
                                                 monkeypatch):
    """A configuration without ``"reference"``, or naming a file that is
    not there, fails in ``load_cell`` with the path in the message; no
    architecture is taken by default."""
    cell = "bloom3b-w8a16-epoch"
    if fault == "no_key":
        conf = json.loads((ROOT / "perfbench/configs/bloom-3b.json")
                          .read_text())
        del conf["reference"]
        path = tmp_path / "bloom-3b.json"
        path.write_text(json.dumps(conf))
        b = copy.deepcopy(bench.benchmark())
        for c in b["configs"]:
            if c["name"] == "bloom-3b":
                c["file"] = str(path)
        monkeypatch.setattr(bench, "benchmark", lambda: b)
        with pytest.raises(KeyError, match=re.escape(str(path))):
            bench.load_cell(cell)
    else:
        missing = "perfbench/reference/no_such_arch.py"
        with pytest.raises(FileNotFoundError, match=re.escape(missing)):
            bench.load_cell(cell, {"config": {"reference": missing}})


def test_every_config_names_its_module():
    for c in bench.benchmark()["configs"]:
        conf = bench.load_json(ROOT / c["file"])
        mod = bench.arch_module(conf, c["file"])
        assert Path(mod.__file__).resolve() == ROOT / conf["reference"]
        assert conf["reference"].startswith("perfbench/reference/")


# -- BLOOM's module reads what the harness read before ------------------------

@pytest.mark.parametrize("seed", sorted(FROZEN_PARAMS))
def test_bloom_weights_and_logits_are_the_parents(seed):
    p = bloom.make_params(TINY, seed, "cpu")
    assert _digest(_leaves(p)) == FROZEN_PARAMS[seed]
    for bits in (8, 4, 0):
        got = bloom.forward_rows(p, TINY, 16, _rows(bits), "cpu")
        assert _digest(got) == FROZEN_LOGITS[(seed, bits)], bits


@pytest.mark.parametrize("name", sorted(FROZEN_FLOPS))
def test_bloom_flops_are_the_parents(name):
    m = TINY if name == "tiny" else json.loads(
        (ROOT / f"perfbench/configs/{name}.json").read_text())["model"]
    got = [bloom.prompt_flops(m, *a) for a in FLOP_ARGS[0]] \
        + [bloom.tokens_flops(m, *a) for a in FLOP_ARGS[1]]
    assert got == FROZEN_FLOPS[name]


def test_rows_at_mixed_precisions_read_as_alone():
    """One call over rows served at different precisions gives each row
    the logits that a call at its precision alone gives, to the bit."""
    p = bloom.make_params(TINY, 5, "cpu")
    specs = [8, (8, 8), 4, 0, (4, 8)]
    rows = [dict(r, bits=b) for b, r in zip(specs, _rows(0) + _rows(0))]
    mixed = bloom.forward_rows(p, TINY, 16, rows, "cpu")
    for r, got in zip(rows, mixed):
        alone, = bloom.forward_rows(p, TINY, 16, [r], "cpu")
        assert torch.equal(got, alone), r["bits"]


# -- W8A8 ---------------------------------------------------------------------

def test_fake_quant_rows_is_the_programs_quantization():
    from repro_torch.quant.ptq import quantize_rowwise
    x = torch.randn(6, 96, generator=torch.Generator().manual_seed(3))
    x[2] = 0.0
    x[4, 7] = 1e3
    q, scale = quantize_rowwise(x)
    assert torch.equal(bloom.fake_quant_rows(x), q.float() * scale)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7])
def test_w8a8_reference_matches_the_program_forward(seed):
    """The reference at (8, 8) against the program's CPU forward on its
    W8A8 tree (every matmul's input quantized per row, int8 weights), a
    reduced BLOOM at float32, logits at every position.  Tolerance 6e-3,
    from readings on seeds 0-19 and 2**31 + 7: on 19 of them the two
    agree within 3.6e-7; on seeds 1 and 12 they read 4.1e-3 and 2.7e-3.
    The two sides' float32 activations differ by rounding (attention and
    norms sum in other orders), and an activation that lies within that
    rounding of a boundary of its row's int8 grid is quantized one step
    (absmax / 127) apart on the two sides; through attention the step
    reaches the later positions.  The same rows judged at weights-only
    int8, as the check judged every row before, read 9.3e-3 to 1.8e-2
    against the program's W8A8 logits on those seeds: beyond the
    tolerance on each."""
    from perfbench.harness.runner import port_config
    from repro_torch.models import transformer
    from repro_torch.quant.ptq import quantize_tree
    model = dict(TINY, dtype="float32")
    cfg = port_config(bloom, model, "bloom-3b", reduced=True)
    params = bloom.make_params(model, seed, "cpu")
    tokens = np.random.default_rng(seed).integers(0, 512, size=(2, 24))
    got = transformer.forward(cfg, quantize_tree(params, 8, act_bits=8),
                              {"tokens": torch.from_numpy(tokens)})
    got = got[:, 15:, :512]
    rows = [dict(prompt=t[:16], gap=0, fed=t[16:], bits=(8, 8))
            for t in tokens]
    ref = bloom.forward_rows(params, model, 16, rows)
    w8 = bloom.forward_rows(params, model, 16,
                            [dict(r, bits=8) for r in rows])
    for b in range(2):
        torch.testing.assert_close(ref[b], got[b], rtol=0, atol=6e-3)
    assert max(float((w - g).abs().max()) for w, g in zip(w8, got)) > 6e-3


def test_w8a8_cell_is_judged_at_its_precision():
    """A cell served at W8A8 (the configuration's engine at (8, 8) and
    its method W8A8) comes in as data: its rows carry (8, 8), the check
    passes them, and the control (int4 weights, int8 activations) does
    not."""
    from perfbench.harness.check import control_verdict
    from perfbench.harness.runner import run_cell
    keep = {}
    over = _tiny(config={"engine": {"quant_bits": [8, 8]},
                         "env": {"method": "W8A8"}})
    r = run_cell("bloom3b-w8a16-epoch", 2 ** 31 + 23, 1.0, False,
                 time.perf_counter(), device="cpu", override=over,
                 keep=keep)
    assert {r_["bits"] for r_ in keep["sample"]} == {(8, 8)}
    assert r["correct"] is True
    ctrl = control_verdict(keep)
    assert ctrl["correct"] is False and ctrl["failed"] > 0


@pytest.mark.parametrize("cell", ["bloom3b-w8a16-epoch",
                                  "bloom3b-w8a16-continuous"])
def test_auto_mix_is_judged_row_by_row(cell):
    """Under ``dftsp:quant=auto,split=true`` one window serves calls at
    several precisions (the choice follows swap costs measured on the
    CPU, so which ones varies from run to run): each row carries the
    spec its call was served at, each row's gaps are those of the
    reference at that spec alone, and the check passes them.  The
    runtime's calibration and swap costs reach the cell's policy through
    the harness's timing wrapper (a ``split`` policy's continuous run
    raised there before)."""
    from perfbench.harness.check import served_gaps
    from perfbench.harness.runner import run_cell
    keep = {}
    over = _tiny(traffic={"policy": "dftsp:quant=auto,split=true"})
    r = run_cell(cell, 2 ** 31 + 29, 2.0, False, time.perf_counter(),
                 device="cpu", override=over, keep=keep)
    assert {r_["bits"] for r_ in keep["sample"]} <= {0, 8, 4, (8, 8)}
    assert r["correct"] is True
    for row, gaps in zip(keep["sample"], keep["gaps"]):
        alone, = served_gaps(bloom, keep["params"], keep["model"],
                             keep["s_max"], [row], "cpu")
        assert np.array_equal(alone, gaps), row["bits"]


def test_control_steps_each_row_down():
    """The control takes each row one step down in weight bits, its
    activations as served, and judges it at its served precision."""
    from perfbench.harness import check
    specs = [0, 8, (8, 8), 4]
    assert [check.lower_precision(b) for b in specs] == [8, 4, (4, 8), 2]
    seen = []

    class Arch:
        @staticmethod
        def forward_rows(params, model, s_max, rows, device):
            seen.append([r["bits"] for r in rows])
            return [torch.zeros(len(r["fed"]) + 1, 8) for r in rows]
    rows = [dict(prompt=[1, 2], gap=0, tokens=np.array([3, 4]), bits=b)
            for b in specs]
    keep = dict(arch_module=Arch, params=None, model=None, s_max=4,
                sample=rows, device="cpu", limit=0.5)
    assert check.control_verdict(keep)["correct"] is True
    assert seen == [[8, 4, (4, 8), 2], specs]


# -- graph_nodes -------------------------------------------------------------

def test_graph_nodes_reads_the_captures():
    read = bench.metric_reader("graph_nodes")

    class Run:
        engine_info = dict(tier="k1", captures=[])
    assert read(Run) is None
    Run.engine_info = dict(tier="k1", captures=[
        dict(nodes=n, ms=1.0) for n in (393, 393, 401)])
    assert read(Run) == 393

"""The port's measured calibration (``repro_torch.quant.calibration``)
against the JAX package's ``repro.quant.calibration``.

Pure functions are held field for field: ``measured_methods`` and
``attach_alphas`` on the records committed in
``experiments/benchmarks/quant_splits.json`` and ``calibration_flip.json``
(read only) and on a hand-made one, and ``measure_alpha`` on the same
float32 weights (handed over through ``repro_torch.bridge``) exactly, at
bits 8 and 4.  ``measure_dppl`` on the same weights and the same eval
batch agrees within a relative 1e-4 (float32; the two forwards sum in
another order).  The timers run on a CPU engine here: their records must
have the JAX package's keys, ``backend == "cpu"`` and every method.  A
``ContinuousRuntime`` with one frozen measured record and one frozen swap
record installed in both packages' policies serves the same counts as the
JAX package's on the same traffic.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.environment import paper_env as jpaper_env  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.request import ReplayGenerator as JReplay  # noqa: E402
from repro.quant import calibration as jcal  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import runtime as jrt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.core.environment import paper_env  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.quantization import METHODS  # noqa: E402
from repro_torch.core.request import ReplayGenerator  # noqa: E402
from repro_torch.quant import calibration as tcal  # noqa: E402
from repro_torch.serving.engine import ServingEngine, tiny_engine  # noqa: E402
from repro_torch.serving.runtime import (ContinuousRuntime,  # noqa: E402
                                         EngineContinuousExecutor)

ROOT = Path(__file__).resolve().parent.parent
ARTIFACTS = ROOT / "experiments" / "benchmarks"


def _committed(name):
    return json.loads((ARTIFACTS / f"{name}.json").read_text())["meta"]["record"]


def _hand_made():
    """A beta record at W8A8 / W8A16 parity (where W8A8 drops out of the
    candidate set) with one method carrying no alpha."""
    per = {"per_batch": {"1": 1.0}, "tok_s_fp": {"1": 10.0},
           "tok_s": {"1": 10.0}}
    return {"batches": [1], "iters": 1, "backend": "cuda",
            "arch": "bloom-7b1", "methods": {
                "W16A16": {"beta": 1.0, **per},
                "W8A16": {"beta": 0.62, "alpha_w": 0.51, **per},
                "W8A8": {"beta": 0.58, "alpha_w": 0.51, **per},
                "W4A16-GPTQ": {"beta": 0.88, **per}}}


def _fields(methods):
    return {name: dataclasses.asdict(m) for name, m in methods.items()}


@pytest.mark.parametrize("round_to", [0.25, 0.0])
@pytest.mark.parametrize("which", ["calibration_flip", "hand_made"])
def test_measured_methods_equal_reference(which, round_to):
    rec = _hand_made() if which == "hand_made" else _committed(which)
    got = tcal.measured_methods(copy.deepcopy(rec), round_to=round_to)
    want = jcal.measured_methods(copy.deepcopy(rec), round_to=round_to)
    assert _fields(got) == _fields(want)
    assert set(got) == set(rec["methods"])


def test_swap_record_committed_reads_the_same():
    """The committed swap record keys the same canonical precisions as the
    port's ``measure_swap_cost``."""
    rec = _committed("quant_splits")
    assert set(rec["methods"]) == set(METHODS)
    assert set(rec) <= {"iters", "backend", "arch", "batch", "n_tokens",
                        "methods", "pairs", "default_s"}


@functools.lru_cache(maxsize=None)
def _trees():
    cfg = jget_arch("bloom-7b1").scaled(n_layers=2, d_model=64, n_heads=2,
                                        n_kv_heads=2, d_ff=128, vocab=256,
                                        dtype="float32")
    je = jeng.ServingEngine(cfg, seed=3, batch_capacity=2, s_max=8, n_max=4)
    tp = bridge.from_jax_params(jax.device_get(je._raw_params),
                                device="cpu")
    return cfg, je._raw_params, tp


@pytest.mark.parametrize("bits", [8, 4])
def test_measure_alpha_equals_reference(bits):
    _, jp, tp = _trees()
    assert tcal.measure_alpha(tp, bits) == jcal.measure_alpha(jp, bits)


@pytest.mark.parametrize("which", ["calibration_flip", "hand_made"])
def test_attach_alphas_equals_reference(which):
    _, jp, tp = _trees()
    rec = _hand_made() if which == "hand_made" else _committed(which)
    got = tcal.attach_alphas(copy.deepcopy(rec), tp)
    want = jcal.attach_alphas(copy.deepcopy(rec), jp)
    assert got == want
    assert _fields(tcal.measured_methods(got)) == \
        _fields(jcal.measured_methods(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_measure_dppl_equals_reference(bits):
    cfg, jp, tp = _trees()
    tcfg = get_arch("bloom-7b1").scaled(n_layers=2, d_model=64, n_heads=2,
                                        n_kv_heads=2, d_ff=128, vocab=256,
                                        dtype="float32")
    tb = tcal.synthetic_eval_batch(tcfg, batch=2, seq=16, seed=1)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    got = tcal.measure_dppl(tcfg, tp, bits, tb)
    want = jcal.measure_dppl(cfg, jp, bits, jb)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * want[1])
    rec = tcal.calibrate(tcfg, tp, bits, tb)
    assert set(rec) == {"alpha_w", "fp_bytes", "q_bytes", "dppl", "ppl_fp",
                        "ppl_quant", "bits"}


def _cpu_engine():
    return tiny_engine("bloom-7b1", device="cpu", seed=1, batch_capacity=4,
                       s_max=8, n_max=4)


def test_measure_beta_record_on_a_cpu_engine():
    eng = _cpu_engine()
    rec = tcal.measure_beta(eng, batches=(1, 2), iters=1, n_tokens=2,
                            prompt_len=3, min_batch=2)
    assert set(rec) == set(_committed("calibration_flip"))
    assert rec["backend"] == "cpu" and rec["arch"] == "bloom-7b1"
    assert set(rec["methods"]) == set(METHODS)
    for meas in rec["methods"].values():
        assert set(meas) == {"beta", "per_batch", "tok_s_fp", "tok_s"}
        assert meas["beta"] > 0 and set(meas["per_batch"]) == {"1", "2"}
    tcal.attach_alphas(rec, eng._raw_params)
    methods = tcal.measured_methods(rec)
    assert methods["W8A16"].alpha_w == pytest.approx(
        tcal.measure_alpha(eng._raw_params, 8)[0])


def test_measure_swap_cost_record_on_a_cpu_engine():
    eng = _cpu_engine()
    rec = tcal.measure_swap_cost(eng, iters=1)
    assert set(rec) == set(_committed("quant_splits"))
    assert rec["backend"] == "cpu" and set(rec["methods"]) == set(METHODS)
    # W8A16 and W8A8 are distinct trees in the port on every device
    keys = {"0", "8", "(8, 8)", "4"}
    assert set(rec["methods"].values()) == keys
    assert set(rec["pairs"]) == {f"{a}->{b}" for a in keys for b in keys
                                 if a != b}
    assert rec["default_s"] == max(p["swap_s"] for p in rec["pairs"].values())


def _frozen_records():
    """One measured-beta record and one swap record, fixed numbers: W8A8
    and W8A16 at parity, W4A16 slower than fp, a costly swap into 4-bit."""
    beta = {"W16A16": 1.0, "W8A16": 0.74, "W8A8": 0.71, "W4A16-GPTQ": 1.3,
            "W4A16-ZQL": 1.2}
    rec = {"batches": [1, 4], "iters": 1, "backend": "cpu",
           "arch": "bloom-7b1", "methods": {
               n: {"beta": b, "per_batch": {"4": b}, "tok_s_fp": {"4": 1.0},
                   "tok_s": {"4": 1.0 / b}} for n, b in beta.items()}}
    keys = {"W16A16": "0", "W8A16": "8", "W8A8": "(8, 8)",
            "W4A16-GPTQ": "4", "W4A16-ZQL": "4"}
    pairs = {f"{a}->{b}": {"swap_s": 0.5 if b == "4" else 0.02,
                           "t_swap": 1.0, "t_stay": 1.0}
             for a in set(keys.values()) for b in set(keys.values())
             if a != b}
    swap = {"iters": 1, "backend": "cpu", "arch": "bloom-7b1", "batch": 2,
            "n_tokens": 2, "methods": keys, "pairs": pairs,
            "default_s": 0.5}
    return rec, swap


def test_continuous_runtime_with_frozen_records_matches_jax():
    """``dftsp:quant=auto,split=true,calib=measured`` on reduced BLOOM-7B1
    with the same frozen records installed in both packages' policies (so
    neither calibrates): the same counts, cohorts and methods, epoch by
    epoch."""
    dims = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=256, dtype="float32")
    kw = dict(batch_capacity=4, s_max=16, n_max=8)
    jcfg = jget_arch("bloom-7b1").scaled(**dims)
    je = jeng.ServingEngine(jcfg, seed=0, **kw)
    te = ServingEngine(get_arch("bloom-7b1").scaled(**dims),
                       params=bridge.from_jax_params(
                           jax.device_get(je._raw_params), device="cpu"),
                       device="cpu", **kw)
    spec = "dftsp:quant=auto,split=true,calib=measured"
    epochs, rate = 5, 6.0
    runs = []
    for env, replay, ex, rt, eng, cal, pol in (
            (jpaper_env("bloom-7b1", "W8A16"), JReplay,
             jrt.EngineContinuousExecutor, jrt.ContinuousRuntime, je, jcal,
             jget_policy),
            (paper_env("bloom-7b1", "W8A16"), ReplayGenerator,
             EngineContinuousExecutor, ContinuousRuntime, te, tcal,
             get_policy)):
        rec, swap = _frozen_records()
        policy = pol(spec)
        policy.install_measured(cal.measured_methods(
            cal.attach_alphas(rec, eng._raw_params)))
        policy.install_swap_costs(swap)
        traffic = replay.poisson(rate, (epochs - 1) * env.T_E, seed=1,
                                 lengths=(4, 8))
        m = rt(env, policy, ex(eng, seed=0), k=2).run(
            gen=replay(traffic.requests), n_epochs=epochs, seed=0,
            warmup_epochs=0)
        assert m.arrived == m.served + m.dropped + m.shed \
            + len(m.final_queue_rids) + len(m.in_flight_rids)
        runs.append(m)
    want, got = runs
    assert (got.arrived, got.served, got.dropped, got.generated_tokens) == \
        (want.arrived, want.served, want.dropped, want.generated_tokens)
    assert [t.selected_rids for t in got.traces] == \
        [t.selected_rids for t in want.traces]
    assert [t.quants for t in got.traces] == [t.quants for t in want.traces]
    assert got.served_by_method == want.served_by_method
    assert got.served > 0

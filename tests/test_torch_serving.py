"""The port's serving engine and epoch runtime against the JAX package's.

Both sides get the same float32 weights (the JAX tree handed over through
``repro_torch.bridge``) and the same prompts, made with numpy from a seed.
The JAX engine dequantizes quantized trees at load on this CPU; the port
keeps QTensor leaves and runs them through the kernels' plain versions.
Greedy tokens are compared for equality.
"""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.core.environment import paper_env as jpaper_env  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.core.request import RequestGenerator as JGen  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.runtime import EngineExecutor as JExec  # noqa: E402
from repro.serving.runtime import EpochRuntime as JRuntime  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.core.environment import paper_env  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.request import RequestGenerator  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.runtime import EngineExecutor, EpochRuntime  # noqa: E402

ENGINE_KW = dict(batch_capacity=3, s_max=16, n_max=10)
# the shape of both packages' tiny_engine, at float32
TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=256, dtype="float32")


@functools.lru_cache(maxsize=None)
def _engines(bits):
    """(JAX engine, port engine) on the same reduced float32 BLOOM."""
    jcfg = reduced_cfg("bloom-3b").scaled(dtype="float32")
    je = jeng.ServingEngine(jcfg, quant_bits=bits, seed=3, **ENGINE_KW)
    tp = bridge.from_jax_params(jax.device_get(je._raw_params),
                                device="cpu")
    tcfg = get_arch("bloom-3b").scaled(**REDUCTIONS["bloom-3b"],
                                       dtype="float32")
    te = teng.ServingEngine(tcfg, params=tp, quant_bits=bits, device="cpu",
                            **ENGINE_KW)
    return je, te


def _prompts(seed, lens=(5, 16, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist() for n in lens]


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_generate_matches_jax_engine(bits):
    je, te = _engines(bits)
    for seed, caps in [(0, [10, 3, 7]), (1, None), (2, [1, 10])]:
        prompts = _prompts(seed, (5, 16, 9) if seed != 2 else (20, 2))
        want = je.generate(prompts, caps)
        for use_kernel in (False, True):
            te.use_kernel = use_kernel
            got = te.generate(prompts, caps)
            np.testing.assert_array_equal(got.tokens, want.tokens)
            np.testing.assert_array_equal(got.lengths, want.lengths)
            assert got.batch == want.batch


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
def test_generate_equals_generate_reference(bits):
    _, te = _engines(8)
    te.use_kernel = True
    prompts = _prompts(4)
    for caps in ([10, 4, 0], [2, 10, 10]):
        a = te.generate(prompts, caps, quant_bits=bits)
        b = te.generate_reference(prompts, caps, quant_bits=bits)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.lengths, b.lengths)


def test_eos_stops_a_row():
    """A row that emits the EOS id emits nothing after it."""
    _, te = _engines(0)
    prompts = _prompts(5)
    first = te.generate(prompts, [6, 6, 6]).tokens
    te.eos_id = int(first[0, 2])
    stop = int(np.flatnonzero(first[0] == te.eos_id)[0]) + 1
    try:
        got = te.generate(prompts, [6, 6, 6])
        ref = te.generate_reference(prompts, [6, 6, 6])
    finally:
        te.eos_id = 0
    assert got.lengths[0] == stop <= 3
    assert not got.tokens[0, stop:].any()
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def test_canon_bits_keeps_w8a8_distinct():
    c = teng.ServingEngine._canon_bits
    assert c((8, 8)) == (8, 8) and c((8, 16)) == 8 and c(16) == 0
    assert c((4, 16)) == 4 and c((0, 8)) == 0
    _, te = _engines(8)
    assert te.params_for((8, 8)) is not te.params_for(8)
    assert te.params_for((8, 8))["layers"][0]["attn"]["wq"].act_bits == 8


def test_cuda_device_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.tiny_engine("bloom-3b")


def test_tiny_engine_shape_matches_jax():
    te = teng.tiny_engine("bloom-3b", device="cpu")
    je_cfg = get_arch("bloom-3b").scaled(**{k: v for k, v in TINY.items()
                                            if k != "dtype"})
    assert te.cfg == je_cfg
    assert te.params["embed"].shape == (256, 64)


class _TransferProbe:
    """Counts, while active, the calls that copy between devices (``.to``
    a device, ``.cpu``, ``.cuda``, a tensor made from host data on a
    device) or wait for a device value."""
    SYNCS = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.copies = {"to": 0, "cpu": 0, "cuda": 0, "tensor": 0,
                       "as_tensor": 0}
        self.syncs = {name: 0 for name in self.SYNCS}
        to, cpu, cuda = torch.Tensor.to, torch.Tensor.cpu, torch.Tensor.cuda

        def counted_to(t, *args, **kw):
            moves = "device" in kw or any(
                isinstance(a, (torch.device, str, torch.Tensor)) for a in args)
            self.copies["to"] += bool(moves)
            return to(t, *args, **kw)

        def counted(name, fn):
            def wrapper(t, *args, **kw):
                self.copies[name] += 1
                return fn(t, *args, **kw)
            return wrapper

        def counted_ctor(name, fn):
            def wrapper(*args, **kw):
                self.copies[name] += "device" in kw
                return fn(*args, **kw)
            return wrapper

        monkeypatch.setattr(torch, "tensor",
                            counted_ctor("tensor", torch.tensor))
        monkeypatch.setattr(torch, "as_tensor",
                            counted_ctor("as_tensor", torch.as_tensor))
        monkeypatch.setattr(torch.Tensor, "to", counted_to)
        monkeypatch.setattr(torch.Tensor, "cpu", counted("cpu", cpu))
        monkeypatch.setattr(torch.Tensor, "cuda", counted("cuda", cuda))
        for name in self.SYNCS:
            fn = getattr(torch.Tensor, name)

            def sync(t, *args, _n=name, _fn=fn, **kw):
                self.syncs[_n] += 1
                return _fn(t, *args, **kw)
            monkeypatch.setattr(torch.Tensor, name, sync)


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
def test_generate_makes_one_copy_each_way(monkeypatch, bits):
    """One host->device copy of (prompts, caps) and one device->host copy
    of (tokens, lengths) per generate; no device value is read inside."""
    _, te = _engines(8)
    te.use_kernel = True
    te.params_for(bits)             # quantize outside the probe
    probe = _TransferProbe(monkeypatch)
    res = te.generate(_prompts(6), [10, 7, 2], quant_bits=bits)
    monkeypatch.undo()
    assert probe.copies == {"to": 1, "cpu": 1, "cuda": 0, "tensor": 0,
                            "as_tensor": 0}, probe.copies
    assert not any(probe.syncs.values()), probe.syncs
    assert res.lengths.tolist() == [10, 7, 2]


# ---------------------------------------------------------------------------
# Control plane: DFTSP decisions and the epoch runtime
# ---------------------------------------------------------------------------


def _frozen_queue(gen_cls, rate, seed, horizon=4.0):
    gen = gen_cls(rate=rate, seed=seed, lengths=(128, 256, 512))
    q = gen.within(0.0, horizon)
    for r in q:
        r.t_w = horizon - r.arrival
    return q


def _summary(decision, env):
    subs = [([r.rid for r in b], q.name)
            for b, q in decision.sub_batches(None, env)] \
        if decision.batches.get(None) else []
    return ([r.rid for r in decision.selected], subs,
            decision.stats.nodes_visited)


@pytest.mark.parametrize("spec", ["dftsp", "dftsp:quant=auto",
                                  "dftsp:quant=auto,split=true", "stb",
                                  "dftsp:d_sweep=false"])
@pytest.mark.parametrize("rate,seed", [(6.0, 0), (12.0, 1), (25.0, 2)])
def test_scheduler_decisions_match_jax(spec, rate, seed):
    for model in ("bloom-3b", "opt-13b"):
        env, jenv = paper_env(model), jpaper_env(model)
        d = get_policy(spec).schedule(env, _frozen_queue(RequestGenerator,
                                                         rate, seed))
        jd = jget_policy(spec).schedule(jenv, _frozen_queue(JGen, rate, seed))
        assert _summary(d, env) == _summary(jd, jenv), (model, spec)


def _trace_counts(m):
    return (m.arrived, m.served, m.dropped, m.truncated, m.generated_tokens,
            m.batch_sizes, m.served_by_method,
            [t.selected_rids for t in m.traces], m.final_queue_rids)


def test_epoch_runtime_matches_jax():
    """EpochRuntime + dftsp + EngineExecutor on the tiny engine shape at a
    fixed rate and seed: the same requests are served, dropped and cut,
    and the same number of tokens comes out."""
    kw = dict(batch_capacity=4, s_max=24, n_max=12, quant_bits=8)
    jcfg = jeng.tiny_engine("bloom-3b").cfg.scaled(dtype="float32")
    je = jeng.ServingEngine(jcfg, seed=0, **kw)
    te = teng.ServingEngine(
        get_arch("bloom-3b").scaled(**TINY),
        params=bridge.from_jax_params(jax.device_get(je._raw_params),
                                      device="cpu"),
        device="cpu", **kw)
    want = JRuntime(jpaper_env("bloom-3b"), jget_policy("dftsp"),
                    JExec(je, seed=5)).run(rate=9.0, n_epochs=4, seed=7)
    got = EpochRuntime(paper_env("bloom-3b"), get_policy("dftsp"),
                       EngineExecutor(te, seed=5)).run(rate=9.0, n_epochs=4,
                                                       seed=7)
    assert _trace_counts(got) == _trace_counts(want)
    assert got.served > 0 and got.generated_tokens > 0

"""The port's hardware, shape, mesh and quantization records (M11a) and
its cost models against the JAX package's: the copied records equal
field by field, ``tpu_env`` prices and schedules exactly as the
reference's does, ``h100_env`` serves at least what the paper's testbed
serves, and the serve launcher's ``--h100-env`` line equals the
reference launcher's on an env of the same constants."""
from __future__ import annotations

import contextlib
import dataclasses
import io

import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.core import environment as jenv  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.serving.runtime import AnalyticExecutor as JAnalytic  # noqa: E402
from repro.serving.runtime import EpochRuntime as JRuntime  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import environment as env  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.runtime import AnalyticExecutor, EpochRuntime  # noqa: E402

ARCHS = config._ARCHS


def _fields(rec):
    return {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}


def test_input_shapes_equal_the_reference():
    assert set(config.INPUT_SHAPES) == set(jconfig.INPUT_SHAPES)
    for name, shape in config.INPUT_SHAPES.items():
        assert _fields(shape) == _fields(jconfig.INPUT_SHAPES[name])
        assert _fields(config.get_shape(name)) == \
            _fields(jconfig.get_shape(name))


@pytest.mark.parametrize("name", ["V5E", "SINGLE_POD", "MULTI_POD"])
def test_records_equal_the_reference(name):
    got, want = getattr(config, name), getattr(jconfig, name)
    assert _fields(got) == _fields(want)
    if hasattr(want, "n_devices"):
        assert got.n_devices == want.n_devices


def test_default_records_equal_the_reference():
    assert _fields(config.HardwareSpec()) == _fields(jconfig.HardwareSpec())
    assert _fields(config.QuantConfig()) == _fields(jconfig.QuantConfig())
    q = dict(name="W8A8", weight_bits=8, act_bits=8, method="gptq")
    assert _fields(config.QuantConfig(**q)) == _fields(jconfig.QuantConfig(**q))


def test_h100_record():
    """The card's record: the same dataclass, the datasheet's bf16 dense
    peak, HBM3 rate and one direction of NVLink 4, the capacity the card
    reports, and the int8 peak beside it."""
    h = config.H100
    assert type(h) is config.HardwareSpec
    assert (h.peak_flops, h.hbm_bw, h.ici_bw) == (989e12, 3.35e12, 450e9)
    assert 79 * 2**30 < h.hbm_bytes < 80 * 2**30
    assert config.H100_INT8_OPS == 1979e12


def test_assigned_archs_equal_the_reference():
    assert config.list_archs(assigned_only=True) == \
        jconfig.list_archs(assigned_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_equal_the_reference(arch):
    assert config.applicable_shapes(config.get_arch(arch)) == \
        jconfig.applicable_shapes(jconfig.get_arch(arch))


def _env_fields(e):
    out = _fields(e)
    out["model"] = out["model"].arch_id
    out["quant"] = out["quant"].name
    return out


@pytest.mark.parametrize("arch,quant,chips", [
    ("bloom-3b", "W8A16", 16), ("bloom-7b1", "W8A8", 8),
    ("opt-13b", "W16A16", 4), ("qwen3-1.7b", "W8A16", 1)])
def test_tpu_env_equals_the_reference(arch, quant, chips):
    got = env.tpu_env(arch, quant, chips=chips)
    want = jenv.tpu_env(arch, quant, chips=chips)
    assert _env_fields(got) == _env_fields(want)
    assert got.T_C == want.T_C


def _run(runtime_cls, e, policy, executor, rate, seed):
    return runtime_cls(e, policy, executor).run(rate=rate, n_epochs=6,
                                                seed=seed)


@pytest.mark.parametrize("rate,seed", [(10.0, 0), (40.0, 1), (80.0, 2)])
def test_dftsp_under_tpu_env_equals_the_reference(rate, seed):
    """DFTSP on the v5e cost model over a frozen trace (seeded arrivals,
    the analytic executor): served and dropped counts, exactly."""
    got = _run(EpochRuntime, env.tpu_env("bloom-3b"), get_policy("dftsp"),
               AnalyticExecutor(), rate, seed)
    want = _run(JRuntime, jenv.tpu_env("bloom-3b"), jget_policy("dftsp"),
                JAnalytic(), rate, seed)
    assert (got.arrived, got.served, got.dropped, got.batch_sizes) == \
        (want.arrived, want.served, want.dropped, want.batch_sizes)
    assert got.served > 0


@pytest.mark.parametrize("arch", ["bloom-3b", "opt-13b"])
def test_h100_env_serves_at_least_paper_env(arch):
    """One H100 has ~37x the bf16 FLOP/s of 20 Jetson TX2s (the
    counterpart of the reference's tpu-vs-paper test)."""
    e = env.h100_env(arch)
    assert (e.C, e.M, e.n_units, e.paper_faithful) == \
        (config.H100.peak_flops, config.H100.hbm_bytes, 1, False)
    r_paper = _run(EpochRuntime, env.paper_env(arch), get_policy("dftsp"),
                   AnalyticExecutor(), 40.0, 0)
    r_h100 = _run(EpochRuntime, e, get_policy("dftsp"), AnalyticExecutor(),
                  40.0, 0)
    assert r_h100.served >= r_paper.served


def _line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("[serve]")]


ARGV = ["--reduced", "--epochs", "2", "--rate", "8", "--s-max", "32",
        "--n-max", "8", "--batch-capacity", "2"]


def test_serve_h100_env_prints_the_reference_line(monkeypatch):
    """``serve --h100-env --device cpu --reduced`` prints the line the
    reference launcher prints on an env of the H100's constants (its
    ``--tpu-env`` flag, pointed at them): the scheduler decides from the
    full config's cost model, so the reduced models' widths do not
    enter."""
    from repro.launch import serve as jserve
    monkeypatch.setattr(jserve, "tpu_env", lambda arch, quant: jenv.tpu_env(
        arch, quant, chips=1, C=config.H100.peak_flops,
        M=config.H100.hbm_bytes))
    want = _line(jserve.main, ARGV + ["--tpu-env"])
    got = _line(serve.main, ARGV + ["--h100-env", "--device", "cpu"])
    assert got == want and len(got) == 1


def test_serve_tpu_env_prints_the_reference_line():
    from repro.launch import serve as jserve
    want = _line(jserve.main, ARGV + ["--tpu-env"])
    got = _line(serve.main, ARGV + ["--tpu-env", "--device", "cpu"])
    assert got == want and len(got) == 1


def test_serve_refuses_two_cost_models():
    with pytest.raises(SystemExit):
        serve.main(ARGV + ["--tpu-env", "--h100-env", "--device", "cpu"])

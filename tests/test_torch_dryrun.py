"""The port's dry run (M11b): one step of a reduced config of each of the
six families, train, prefill and decode, at a ``ShapeConfig`` of 512
tokens, placed on fake meshes of 2 x 2 and 2 x 2 x 2 ranks and traced
over meta tensors.  The record has the reference's keys, its analytic
terms equal the reference's ``analytic_costs`` at that shape, a train
step's traced FLOPs lie within [1, 2) of 6 N D, collectives appear only
with a model axis, a wider model axis holds fewer bytes a device, and
``main`` writes its JSON.  Every process group a test installs is
destroyed with it."""
from __future__ import annotations

import dataclasses
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

sys.path.insert(0, "tests")
from conftest import reduced_cfg  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.serve import reduced  # noqa: E402

# one reduced config a family: OLMo (dense), granite (MoE), InternVL2
# (VLM, 16 image positions so that 64 tokens hold text), xLSTM (ssm),
# Zamba2 (hybrid, 6 layers: one group with its shared attention) and
# Whisper (audio)
FAMILIES = ["olmo-1b", "granite-moe-1b-a400m", "internvl2-26b",
            "xlstm-1.3b", "zamba2-7b", "whisper-tiny"]
KINDS = ["train", "prefill", "decode"]
KEYS = {"chips", "analytic_flops", "analytic_bytes", "traced_flops",
        "traced_bytes", "collective_bytes", "collectives",
        "bytes_per_device", "fits", "t_compute", "t_memory", "t_collective",
        "bottleneck", "model_flops", "useful_compute_ratio", "t_trace_s"}


def _cfgs(arch):
    """(the port's reduced config, the reference's same config)."""
    cfg, jcfg = reduced(config.get_arch(arch)), reduced_cfg(arch)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, vlm=config.VLMConfig(n_img_tokens=16))
        jcfg = dataclasses.replace(jcfg,
                                   vlm=jconfig.VLMConfig(n_img_tokens=16))
    if cfg.family == "hybrid":
        cfg, jcfg = cfg.scaled(n_layers=6), jcfg.scaled(n_layers=6)
    return cfg, jcfg


def _shape(kind, cls=config.ShapeConfig):
    return cls(f"t_{kind}", 64, 8, kind)


def _case(arch, kind, mesh_shape):
    cfg, jcfg = _cfgs(arch)
    rec = dryrun.trace_case(cfg, _shape(kind), mesh_shape, budget_s=240)
    assert not dist.is_initialized()
    return rec, jcfg


def _check(rec, jcfg, kind, chips):
    assert rec["traced"] and KEYS <= set(rec), set(KEYS) - set(rec)
    assert rec["chips"] == chips
    want = janalysis.analytic_costs(jcfg, _shape(kind, jconfig.ShapeConfig))
    assert (rec["analytic_flops"], rec["analytic_bytes"]) == want
    assert rec["model_flops"] == janalysis.model_flops(
        jcfg, _shape(kind, jconfig.ShapeConfig))
    assert rec["bytes_per_device"] > 0 and rec["traced_flops"] > 0
    assert rec["fits"] is (rec["bytes_per_device"] <= config.H100.hbm_bytes)
    if kind == "train":
        # the reference's own sanity bound (6 N D and remat's recompute)
        assert 1.0 <= rec["traced_flops"] / rec["model_flops"] < 2.0


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", KINDS)
def test_run_one_on_2x2(arch, kind):
    rec, jcfg = _case(arch, kind, (2, 2))
    _check(rec, jcfg, kind, 4)
    assert rec["collective_bytes"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_run_one_on_2x2x2(arch, kind):
    rec, jcfg = _case(arch, kind, (2, 2, 2))
    _check(rec, jcfg, kind, 8)
    assert rec["collective_bytes"] > 0


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_collectives_need_a_model_axis(arch):
    """No collective on a 1 x 1 mesh (plain tensors: nothing is placed),
    some with a model axis of 2; the traced FLOPs are the whole step's on
    every mesh."""
    one, _ = _case(arch, "train", (1, 1))
    two, _ = _case(arch, "train", (1, 2))
    assert one["collective_bytes"] == 0 and one["collectives"] == {}
    assert two["collective_bytes"] > 0
    assert two["traced_flops"] == one["traced_flops"]


def test_bytes_per_device_fall_as_the_model_axis_grows():
    got = [_case("olmo-1b", kind, (1, m))[0]["bytes_per_device"]
           for kind in ("decode",) for m in (1, 2, 4)]
    assert got[0] > got[1] > got[2]


def test_main_writes_json(tmp_path):
    """The CLI at a production shape (16 x 16 fake ranks): exit code 0
    and a record of the reference's keys."""
    path = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                      "--single-pod-only", "--json", str(path)])
    assert rc == 0 and not dist.is_initialized()
    out = json.loads(path.read_text())
    assert out["failures"] == [] and out["not_traced"] == []
    (rec,) = out["results"]
    assert KEYS <= set(rec) and rec["chips"] == 256
    assert (rec["arch"], rec["shape"], rec["mesh"]) == \
        ("qwen3-1.7b", "decode_32k", "16x16")
    assert rec["analytic_flops"] == janalysis.analytic_costs(
        jconfig.get_arch("qwen3-1.7b"), jconfig.get_shape("decode_32k"))[0]


def test_a_case_past_its_budget_is_not_traced():
    cfg, _ = _cfgs("olmo-1b")
    rec = dryrun.trace_case(cfg, _shape("train"), (2, 2), budget_s=0.01)
    assert rec["traced"] is False and "not traced whole" in rec["reason"]
    assert not dist.is_initialized()


def test_import_changes_no_state():
    import importlib
    assert not dist.is_initialized()
    importlib.reload(dryrun)
    from repro_torch.launch import mesh
    importlib.reload(mesh)
    assert not dist.is_initialized()

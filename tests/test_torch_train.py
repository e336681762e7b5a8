"""The port's training substrate (``repro_torch.train``, ``launch.steps``,
``launch.train``) against ``repro.train`` on the CPU: AdamW and its
schedule on seeded trees, the trainer's loss curve from the same weights
(ROADMAP's M10 gate), a resume from the reference's AdamW state, the
microbatched step, the data pipeline, checkpoints and the launcher; and
one train step of every carried config.

Tolerances, float32 unless named: AdamW's params, moments, grad_norm and
lr at rtol 1e-6 (the same float32 operations in the same order; the
global norm sums its leaves in another order, so where it clips, the
gradients are chosen to make that sum exact); bfloat16 params within one
bf16 ulp (rtol 2^-7), their float32 moments at rtol 1e-6; the trainer's
loss and grad_norm at rtol 1e-5 and lr at 1e-6 over 5 steps, and each
param leaf's total update within 1e-3 of the reference's in L2 norm
(measured up to 8e-5: Adam's normalised step turns a gradient element
near zero, where the two packages' 1e-6-relative differences are large
against the element, into an update of full size).  ``SyntheticLM``
is held bitwise.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import _ARCHS, get_arch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.serve import reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.train import checkpoint, data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import Trainer, TrainState  # noqa: E402
from repro_torch.train.trainer import to_batch, value_and_grad  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BF16_ULP = 2 ** -7


def _tree(seed):
    """A seeded param-like tree in the JAX package's layout (a layer stack
    ``layers`` of 2 layers, each with a matrix-shaped and a vector leaf;
    unstacked matrices, a vector, a scalar and a None leaf), and a
    gradient tree of its shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "s": (),
              "layers": {"a": (2, 4, 5), "g": (2, 5)}}

    def build(sh, scale):
        if isinstance(sh, dict):
            return {k: build(v, scale) for k, v in sh.items()}
        return (rng.standard_normal(sh) * scale).astype(np.float32)
    p, g = build(shapes, 1.0), build(shapes, 3.0)
    p["none"] = g["none"] = None
    return p, g


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    """The port's tree of a ``_tree`` tree (the layer stack as a list)."""
    return bridge.from_jax_params(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, dtype)), tree), device="cpu")


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.to(torch.float32).numpy()


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clipped):
    """Three AdamW steps on a seeded tree: params, float32 moments, step,
    grad_norm and lr against ``repro.train.optimizer``.  Unclipped, the
    gradients are random and grad_clip is out of reach; clipped, every
    gradient entry is +-2, so the global norm (sqrt(4 N), far above
    grad_clip = 1) has no rounding that depends on the order its sum is
    taken in, and the two clip scales are the same float."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg_kw = dict(lr=0.05, warmup_steps=2, total_steps=6, weight_decay=0.1,
                  grad_clip=1.0 if clipped else 1e9)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    p, _ = _tree(0)
    jp, tp = _jax(p, jdt), _torch(p, jdt)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        _, g = _tree(10 + step)
        if clipped:
            g = jax.tree.map(lambda a: np.where(a < 0, -2.0, 2.0)
                             .astype(np.float32), g)
        jp, js, jm = jopt.adamw_update(jcfg, _jax(g, jdt), js, jp)
        tp, ts, tm = topt.adamw_update(tcfg, _torch(g, jdt), ts, tp)
        assert (float(jm["grad_norm"]) > jcfg.grad_clip) == clipped
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for mine, ref in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(tree_leaves(mine), tree_leaves(_torch(
                    jax.device_get(ref), jnp.float32))):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=0)
        rtol = 1e-6 if dtype == "float32" else BF16_ULP
        for a, b in zip(tree_leaves(tp), tree_leaves(_torch(
                jax.device_get(jp), jdt))):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=0)


def test_decay_follows_the_reference_stacked_rank():
    """F7: a leaf decays where its JAX-package counterpart has ndim >= 2,
    so every leaf of a stacked layer does (a layer's vector is a matrix in
    the stack) and an unstacked vector does not."""
    tp = _torch(_tree(0)[0], jnp.float32)
    names = ["b", "layers/0/a", "layers/0/g", "layers/1/a", "layers/1/g",
             "s", "w"]                                  # flatten order
    assert len(tree_leaves(tp)) == len(names)
    assert dict(zip(names, topt.decay_flags(tp))) == {
        "b": False, "layers/0/a": True, "layers/0/g": True,
        "layers/1/a": True, "layers/1/g": True, "s": False, "w": True}
    mixed = {"main": [{"A_log": torch.zeros(3)}], "slstm": [
        {"b_gates": torch.zeros(3)}], "tail": [{"s": torch.zeros(())}],
        "final_norm": torch.ones(3)}
    # (main: 2 stacked axes, slstm 1, tail 1; a 0-d leaf of a 1-axis stack
    # is a vector in the reference)
    assert topt.decay_flags(mixed) == [False, True, True, False]


def test_adamw_decays_matrices_only_and_runs_in_place():
    """With a zero gradient the step is the decay alone: a 2-D leaf shrinks
    by lr * wd, a 1-D leaf stays; the update writes the tensors it was
    given."""
    cfg = topt.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=1,
                           min_lr_ratio=1.0, weight_decay=0.1)
    p = {"w": torch.ones((2, 3)), "b": torch.ones((3,))}
    st = topt.adamw_init(p)
    ids = {k: v.data_ptr() for k, v in p.items()}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    new, st2, m = topt.adamw_update(cfg, g, st, p)
    assert float(m["grad_norm"]) == 0.0
    np.testing.assert_allclose(new["w"].numpy(), 1 - 0.5 * 0.1, rtol=1e-7)
    assert torch.equal(new["b"], torch.ones(3))
    assert all(new[k].data_ptr() == ids[k] for k in p)
    assert st2.mu["w"].dtype == torch.float32


def test_moments_are_f32_for_bf16_params():
    st = topt.adamw_init({"w": torch.ones((2, 2), dtype=torch.bfloat16)})
    assert st.mu["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and int(st.step) == 0


@pytest.mark.parametrize("kw", [dict(), dict(lr=1.0, warmup_steps=10,
                                             total_steps=100,
                                             min_lr_ratio=0.1)])
def test_lr_schedule_and_global_norm_match_reference(kw):
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    for s in (0, 1, 5, 10, 55, 99, 100, 150):
        want = float(jopt.lr_schedule(jcfg, jnp.int32(s)))
        got = float(topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    _, g = _tree(3)
    np.testing.assert_allclose(
        float(topt.global_norm(_torch(g, jnp.float32))),
        float(jopt.global_norm(_jax(g, jnp.float32))), rtol=1e-6)
    assert float(topt.global_norm({"w": torch.full((4,), 10.0)})) == \
        pytest.approx(20.0)


def _trainers(arch, batch=4, seq=32, **opt_kw):
    """(reference Trainer, port Trainer) at float32 on the reduced config,
    the port's state bridged from the reference's initial weights."""
    kw = dict(OPT_KW, **opt_kw)
    jcfg = reduced_cfg(arch).scaled(dtype="float32")
    tcfg = reduced(get_arch(arch)).scaled(dtype="float32")
    jt = jtrainer.Trainer(jcfg, batch=batch, seq=seq,
                          opt_cfg=jopt.AdamWConfig(**kw))
    tt = Trainer(tcfg, batch=batch, seq=seq, opt_cfg=topt.AdamWConfig(**kw),
                 device="cpu")
    return jt, tt


def _bridged(js):
    params = bridge.from_jax_params(jax.device_get(js.params), device="cpu")
    return TrainState(params, bridge.opt_state_from_jax(
        jax.device_get(js.opt), device="cpu"))


def _assert_runs_match(jh, th, js, ts, start):
    """Histories row by row, and the params: each leaf's total update from
    ``start`` (the port's tree both began from) within 1e-3 of the
    reference's, in L2 norm."""
    assert len(jh) == len(th)
    for a, b in zip(th, jh):
        assert set(a) == set(b) and a["step"] == b["step"]
        for k in ("loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
        if "aux_loss" in b:
            np.testing.assert_allclose(a["aux_loss"], b["aux_loss"],
                                       rtol=1e-5, atol=1e-7)
    want = tree_leaves(_bridged(js).params)
    got = tree_leaves(ts.params)
    assert len(got) == len(want) == len(start)
    for g, w, s0 in zip(got, want, start):
        ref = float((w - s0).norm())
        assert ref > 0
        assert float((g - w).norm()) <= 1e-3 * ref
    assert int(ts.opt.step) == int(js.opt.step)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_trainer_loss_curve_matches_reference(arch):
    """The port's Trainer and the reference's from the same weights, 5
    steps on the same batches: loss, grad_norm, lr (and the MoE aux loss)
    every step, and the final params."""
    jt, tt = _trainers(arch)
    js0 = jt.init_state()
    ts = _bridged(js0)
    start = [p.clone() for p in tree_leaves(ts.params)]
    js, jh = jt.run(5, state=js0, log_every=1, log=lambda s: None)
    ts, th = tt.run(5, state=ts, log_every=1, log=lambda s: None)
    assert ("aux_loss" in th[0]) == ("aux_loss" in jh[0])
    _assert_runs_match(jh, th, js, ts, start)


def test_resume_from_reference_opt_state():
    """The reference trains 2 steps; the port resumes from its params and
    AdamW state (``opt_state_from_jax``) and both train 3 more on the same
    batches."""
    jt, tt = _trainers("qwen3-1.7b")
    js, _ = jt.run(2, log_every=10, log=lambda s: None)
    ts = _bridged(js)
    assert int(ts.opt.step) == 2
    start = [p.clone() for p in tree_leaves(ts.params)]
    for _ in range(2):                   # the batches the reference used
        tt.data.next_batch()
    js, jh = jt.run(3, state=js, log_every=1, log=lambda s: None)
    ts, th = tt.run(3, state=ts, log_every=1, log=lambda s: None)
    _assert_runs_match(jh, th, js, ts, start)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_launch_step_matches_reference(microbatches):
    """``make_train_step_fn``, whole and over 2 microbatches (float32
    gradients accumulated over equal slices): metrics and params against
    the reference's step."""
    arch = "olmo-1b"
    jcfg = reduced_cfg(arch).scaled(dtype="float32")
    tcfg = reduced(get_arch(arch)).scaled(dtype="float32")
    jm = japi.build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    b = jdata.SyntheticLM(jcfg, 4, 16).next_batch()
    jfn = jsteps.make_train_step_fn(jm, jopt.AdamWConfig(**OPT_KW),
                                    microbatches=microbatches)
    tfn = tsteps.make_train_step_fn(tapi.build_model(tcfg),
                                    topt.AdamWConfig(**OPT_KW),
                                    microbatches=microbatches)
    tp = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    start = [p.clone() for p in tree_leaves(tp)]
    jp, jo, jmet = jax.jit(jfn)(jp, jopt.adamw_init(jp),
                                {k: jnp.asarray(v) for k, v in b.items()})
    tp, to, tmet = tfn(tp, topt.adamw_init(tp), to_batch(b, "cpu"))
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7)
    want = tree_leaves(bridge.from_jax_params(jax.device_get(jp),
                                              device="cpu"))
    for g, w, s0 in zip(tree_leaves(tp), want, start):
        assert float((g - w).norm()) <= 1e-3 * float((w - s0).norm())


def test_trainer_remat_equals_no_remat():
    """``Trainer(remat=True)`` checkpoints the whole loss, as
    ``jax.checkpoint(loss_fn)`` does: the same history and params as
    without, bitwise on the CPU."""
    cfg = reduced(get_arch("granite-moe-1b-a400m")).scaled(dtype="float32")
    runs = []
    for remat in (False, True):
        tr = Trainer(cfg, batch=2, seq=16, opt_cfg=topt.AdamWConfig(**OPT_KW),
                     remat=remat, device="cpu")
        runs.append(tr.run(3, log_every=1, log=lambda s: None))
    (s0, h0), (s1, h1) = runs
    assert h0 == h1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0.params),
                                                 tree_leaves(s1.params)))


def test_loss_decreases():
    cfg = reduced(get_arch("olmo-1b"))
    tr = Trainer(cfg, batch=8, seq=64, device="cpu")
    _, hist = tr.run(25, log_every=5, log=lambda s: None)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_roundtrip(tmp_path):
    """Params and AdamW state of a bf16 model after 2 steps: restored with
    the same dtypes and, bf16 going through float32, the same values."""
    cfg = reduced(get_arch("qwen3-1.7b"))
    tr = Trainer(cfg, batch=2, seq=16, device="cpu")
    state, _ = tr.run(2, log_every=10, log=lambda s: None)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, (state.params, state.opt))
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]    # no temporary left
    like = (state.params, topt.adamw_init(state.params))
    params, opt = checkpoint.restore(path, like)
    assert isinstance(opt, topt.AdamWState) and int(opt.step) == 2
    for a, b in zip(tree_leaves((state.params, state.opt)),
                    tree_leaves((params, opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path) as data:
        assert sorted(data.files, key=lambda f: int(f[5:])) == \
            [f"leaf_{i}" for i in range(len(tree_leaves(like)))]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"w": torch.ones((2, 2))})
    with pytest.raises(AssertionError):
        checkpoint.restore(path, {"w": torch.ones((3, 3))})


def test_checkpoint_shape_mismatch_rejected_under_python_O(tmp_path):
    """The shape check raises explicitly, so it holds where ``assert``
    statements are stripped."""
    code = (
        "import torch\n"
        "from repro_torch.train import checkpoint\n"
        f"p = {str(tmp_path / 'ck.npz')!r}\n"
        "checkpoint.save(p, {'w': torch.ones((2, 2))})\n"
        "try:\n"
        "    checkpoint.restore(p, {'w': torch.ones((3, 3))})\n"
        "except AssertionError:\n"
        "    print('rejected')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-O", "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "rejected"


@pytest.mark.parametrize("arch", sorted(_ARCHS))
def test_train_step(arch):
    """One train step of every carried config at its reduced shape and
    dtype: finite gradients, not all zero, and the params change."""
    cfg = reduced(get_arch(arch))
    model = tapi.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    before = [p.clone() for p in tree_leaves(params)]
    b = tdata.SyntheticLM(cfg, 2, 16).next_batch()
    (loss, _), grads = value_and_grad(model.loss_fn, params, to_batch(b, "cpu"))
    assert torch.isfinite(loss)
    flat = tree_leaves(grads)
    assert all(bool(torch.isfinite(g.float()).all()) for g in flat), arch
    assert any(float(g.float().abs().max()) > 0 for g in flat), arch
    params, _, _ = topt.adamw_update(topt.AdamWConfig(warmup_steps=0), grads,
                                     topt.adamw_init(params), params)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params))), arch


@pytest.mark.parametrize("arch", ["olmo-1b", "internvl2-26b", "whisper-tiny"])
def test_synthetic_lm_batches_bitwise(arch):
    """Three batches of ``SyntheticLM`` equal the reference's bitwise,
    with the VLM and audio stubs."""
    jcfg, tcfg = reduced_cfg(arch), reduced(get_arch(arch))
    a, b = jdata.SyntheticLM(jcfg, 3, 10, seed=4), \
        tdata.SyntheticLM(tcfg, 3, 10, seed=4)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_data_module_is_the_reference_apart_from_imports():
    ref = (ROOT / "src/repro/train/data.py").read_text().splitlines()
    port = (ROOT / "src/repro_torch/train/data.py").read_text().splitlines()
    assert len(ref) == len(port)
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    assert diff and all(a.startswith(("import ", "from "))
                        and a.replace("repro.", "repro_torch.") == b
                        for a, b in diff), diff


def test_launcher_trains_and_writes_a_checkpoint(tmp_path, capsys):
    """``launch.train.main`` on the CPU at the reduced shape returns 0,
    prints its step lines, and its checkpoint restores into the launcher's
    (params, AdamW state) structure after 3 steps."""
    path = str(tmp_path / "ck.npz")
    rc = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--checkpoint", path])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out[:2]] == [["step", "0"],
                                                        ["step", "2"]]
    assert out[-1] == f"saved {path}"
    cfg = get_arch("olmo-1b").scaled(**dict(tlaunch.REDUCED, n_kv_heads=4))
    params = tapi.build_model(cfg).init(torch.Generator().manual_seed(0))
    _, opt = checkpoint.restore(path, (params, topt.adamw_init(params)))
    assert int(opt.step) == 3


def test_launcher_refuses_a_mesh():
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--reduced", "--model-parallel", "2"])

"""The port's gradients against ``jax.grad`` of the reference's
``loss_fn`` for the transformer family (the recurrent, hybrid and audio
families: ``tests/test_torch_train_recurrent.py``), at float32 on the
reduced configs of ``tests/conftest.py``; a tie of the MoE router; remat
on against off for every family.

Both sides get the same weights (the JAX tree handed over through
``repro_torch.bridge``, the JAX gradient tree bridged the same way) and
the same batch, made with numpy from a seed.  xLSTM and Zamba2 also run
with every kind of block at 5 layers (``-mixed``, as in
``tests/test_torch_recurrent.py``); mixtral-8x22b has a window of 16.
Tolerances: the loss within 1e-5 (relative); every gradient leaf within
1e-4 of that leaf's largest magnitude (the summation orders of the two
packages' float32 products differ: measured up to 3.5e-5 of it, on the
recurrent families).  Remat is held bitwise on the CPU: the recompute
runs the same kernels on the same values."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.launch.serve import reduced  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.utils import remat  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CASES = {"olmo-1b": {}, "qwen3-1.7b": {}, "granite-moe-1b-a400m": {},
         "internvl2-26b": {},
         "xlstm-1.3b-mixed": dict(n_layers=5, xlstm=dict(slstm_every=2)),
         "zamba2-7b-mixed": dict(n_layers=5, hybrid=dict(attn_every=2)),
         "whisper-tiny": {}, "bloom-3b": {}, "mixtral-8x22b": {}}
# one case of each family, and the bodies maybe_remat wraps in its forward
# pass: a layer each (transformer), 2 mLSTM + 2 sLSTM blocks + the tail
# (xLSTM), 4 Mamba2 layers + 2 shared-block sites (Zamba2: the tail is not
# wrapped), 2 encoder + 2 decoder layers (Whisper)
FAMILIES = {"olmo-1b": 2, "granite-moe-1b-a400m": 2, "internvl2-26b": 2,
            "xlstm-1.3b-mixed": 5, "zamba2-7b-mixed": 6, "whisper-tiny": 4}
TRANSFORMER_CASES = ["olmo-1b", "qwen3-1.7b", "granite-moe-1b-a400m",
                     "internvl2-26b", "bloom-3b", "mixtral-8x22b"]
# the bodies a prefill under the remat policy wraps: Whisper's 2 encoder
# layers, which pass no callback
PREFILL_WRAPS = {"whisper-tiny": 2}
B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _scale(cfg, kw):
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in kw.items()}
    return cfg.scaled(**kw)


@functools.lru_cache(maxsize=None)
def _setup(case):
    arch, kw = case.replace("-mixed", ""), CASES[case]
    jcfg = _scale(reduced_cfg(arch), dict(kw, dtype="float32"))
    tcfg = _scale(reduced(get_arch(arch)), dict(kw, dtype="float32"))
    jp = japi.build_model(jcfg).init(jax.random.key(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.vlm.n_img_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (B, jcfg.encdec.n_audio_frames, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, batch


def _port(case):
    """(port model, a fresh bridged param tree, the batch as tensors)."""
    _, tcfg, jp, batch = _setup(case)
    return (tapi.build_model(tcfg),
            bridge.from_jax_params(jax.device_get(jp), device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_grads_match(got, want_jax):
    want = tree_leaves(bridge.from_jax_params(jax.device_get(want_jax),
                                              device="cpu"))
    got = tree_leaves(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), \
            f"leaf {i} {tuple(w.shape)}: max error {err} of scale {scale}"


def _jax_value_and_grad(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(japi.build_model(jcfg).loss_fn,
                                    has_aux=True))
    return fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})


def _check_gradients(case):
    """The loss, the metrics and every gradient leaf against
    ``jax.grad``."""
    jcfg, _, jp, batch = _setup(case)
    (jl, jm), jg = _jax_value_and_grad(jcfg, jp, batch)
    model, tp, tb = _port(case)
    (tl, tm), tg = value_and_grad(model.loss_fn, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL,
                                   atol=1e-7)
    _assert_grads_match(tg, jg)


@pytest.mark.parametrize("case", TRANSFORMER_CASES)
def test_gradients_match_jax_grad(case):
    """The transformer family (dense, MoE, VLM, a sliding window with MoE,
    qk-norm, GQA); the recurrent, hybrid and audio families are in
    ``tests/test_torch_train_recurrent.py``."""
    _check_gradients(case)


def test_moe_router_tie_gradients_match():
    """Two experts with equal router columns in every layer: every token's
    top-2 is a tie, which both packages break towards the lower expert id;
    the gates' and every other gradient must still match ``jax.grad``."""
    jcfg, _, jp, batch = _setup("granite-moe-1b-a400m")
    router = np.array(jp["layers"]["moe"]["router"])        # (L, D, E)
    router[..., 1] = router[..., 0]
    jp = dict(jp, layers=dict(jp["layers"], moe=dict(
        jp["layers"]["moe"], router=jnp.asarray(router))))
    (jl, _), jg = _jax_value_and_grad(jcfg, jp, batch)
    model = tapi.build_model(_setup("granite-moe-1b-a400m")[1])
    tp = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    assert torch.equal(tp["layers"][0]["moe"]["router"][:, 0],
                       tp["layers"][0]["moe"]["router"][:, 1])
    (tl, _), tg = value_and_grad(model.loss_fn, tp,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    _assert_grads_match(tg, jg)


def _counting_checkpoint(monkeypatch):
    calls = []
    real = remat.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(remat, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("case", list(FAMILIES))
def test_remat_on_equals_off_bitwise(case, monkeypatch):
    """The loss and every gradient leaf with the remat policy on equal
    those with it off, bitwise, and the policy wrapped the bodies the JAX
    package wraps."""
    model, tp, tb = _port(case)
    (l0, _), g0 = value_and_grad(model.loss_fn, tp, tb)
    calls = _counting_checkpoint(monkeypatch)
    n_fwd = []

    def loss_fn(p, b):
        out = model.loss_fn(p, b)
        n_fwd.append(len(calls))
        return out

    with remat.remat_scan(True):
        (l1, _), g1 = value_and_grad(loss_fn, tp, tb)
    assert n_fwd == [FAMILIES[case]]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_prefill_under_remat_wraps_nothing(case, monkeypatch):
    """A prefill passes callbacks to the sequence pass: under the remat
    policy no body that calls one is wrapped (a recompute would call it
    twice; Whisper's encoder layers call none), and the logits and cache
    are the ones without it."""
    model, tp, tb = _port(case)
    tb = {k: v for k, v in tb.items() if k != "labels"}
    with torch.no_grad():
        want, cache0 = model.prefill(tp, tb, 0)
        calls = _counting_checkpoint(monkeypatch)
        with remat.remat_scan(True):
            got, cache1 = model.prefill(tp, tb, 0)
    assert len(calls) == PREFILL_WRAPS.get(case, 0)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(cache0), tree_leaves(cache1)):
        assert torch.equal(a, b)

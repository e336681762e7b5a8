"""The port's recurrent, hybrid and audio families (xLSTM, Mamba2 / Zamba2,
Whisper) against ``repro.models``, at float32 on the reduced configs of
``tests/conftest.py``.

Both sides get the same weights (the JAX tree handed over through
``repro_torch.bridge``) and the same inputs, made with numpy from a seed.
The reduced xlstm-1.3b (2 layers) has no sLSTM block and the reduced
zamba2-7b (4 layers) no shared-attention site, so each also runs with
every kind of block at 5 layers (``-mixed``: xLSTM with an sLSTM block
every 2nd, two groups of 1 mLSTM + 1 sLSTM and a tail mLSTM; Zamba2 with
the shared block every 2nd layer, two groups of 2 Mamba2 layers + the
shared block and a tail layer).  Quantized trees are dequantized at load
on both sides, as both engines serve these families.  Tolerances: logits
1e-4 and the chunked scans 1e-5 (relative and absolute); a cache leaf
within 1e-5 of its own largest magnitude (the states reach 5-12, and the
summation-order differences between the two packages' float32 products
grow with them: measured up to 7.3e-6 of it)."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import _ARCHS, EncDecConfig, get_arch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

NEW_ARCHS = ["xlstm-1.3b", "zamba2-7b", "whisper-tiny"]
# the reduced configs, and xLSTM / Zamba2 with every kind of block
CASES = {"xlstm-1.3b": {}, "zamba2-7b": {}, "whisper-tiny": {},
         "xlstm-1.3b-mixed": dict(n_layers=5, xlstm=dict(slstm_every=2)),
         "zamba2-7b-mixed": dict(n_layers=5, hybrid=dict(attn_every=2))}
B, S = 2, 12
TOL = 1e-4
STATE_TOL = 1e-5
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
          "d_ff", "vocab", "norm", "act", "qk_norm", "rope_theta",
          "sliding_window", "tie_embeddings", "dtype", "kv_bits")


def _arch(case):
    return case.replace("-mixed", "")


def _scale(cfg, kw):
    """``cfg.scaled(**kw)``, a dict value replacing fields of that
    sub-config."""
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in kw.items()}
    return cfg.scaled(**kw)


def port_cfg(arch, **kw):
    """``reduced_cfg`` built from the port's own registry, at float32."""
    cfg = get_arch(arch).scaled(**REDUCTIONS[arch])
    if cfg.family == "audio":
        cfg = dataclasses.replace(
            cfg, encdec=EncDecConfig(n_enc_layers=2, n_audio_frames=32))
    return _scale(cfg, dict(kw, dtype="float32"))


def jax_cfg(arch, **kw):
    return _scale(reduced_cfg(arch), dict(kw, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _setup(case):
    arch, kw = _arch(case), CASES[case]
    jcfg, tcfg = jax_cfg(arch, **kw), port_cfg(arch, **kw)
    jp = japi.build_model(jcfg).init(jax.random.key(1))
    tp = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab, size=(B, S)).astype(np.int32)
    audio = None
    if jcfg.family == "audio":
        audio = (rng.standard_normal((B, jcfg.encdec.n_audio_frames,
                                      jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, toks, audio


def _trees(case, bits):
    """(JAX tree, port tree) at ``bits``: quantized and dequantized on
    both sides, as the engines serve these families."""
    jcfg, tcfg, jp, tp, toks, audio = _setup(case)
    if bits:
        jp = jptq.dequantize_tree(jptq.quantize_tree(jp, bits))
        tp = tptq.dequantize_tree(tptq.quantize_tree(tp, bits))
    return jcfg, tcfg, jp, tp, toks, audio


def _batches(toks, audio):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if audio is not None:
        jb["audio_embeds"] = jnp.asarray(audio)
        tb["audio_embeds"] = torch.from_numpy(audio)
    return jb, tb


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _cache_close(tcfg, got, want_jax, tol=STATE_TOL):
    """The port's cache against the JAX cache, leaf by leaf, through the
    cache bridge: max |got - want| <= tol * max(1, max |want|)."""
    want = bridge.cache_from_jax(tcfg, jax.device_get(want_jax), "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            assert g[name].shape == w[name].shape, name
            assert g[name].dtype == w[name].dtype, name
            err = float((g[name] - w[name]).abs().max())
            assert err <= tol * max(1.0, float(w[name].abs().max())), \
                (name, err)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: None if tree is None else (tuple(tree.shape), tree.dtype)}


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and the model factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_copy_matches_reference(arch):
    from repro.config import get_arch as jget_arch
    a, b = jget_arch(arch), get_arch(arch)
    for f in FIELDS + ("source",):
        assert getattr(a, f) == getattr(b, f), (arch, f)
    for sub in ("ssm", "xlstm", "hybrid", "encdec"):
        x, y = getattr(a, sub), getattr(b, sub)
        assert (x is None) == (y is None), sub
        if x is not None:
            # the port's fields beyond the JAX package's (the published
            # Zamba2 block's groups, conv bias and site list) sit at the
            # defaults that give the JAX package's model
            ours, theirs = dataclasses.asdict(y), dataclasses.asdict(x)
            assert {k: ours[k] for k in theirs} == theirs, sub
            assert {k: v for k, v in ours.items() if k not in theirs} == \
                {k: v for k, v in dataclasses.asdict(type(y)()).items()
                 if k not in theirs}, sub
    assert a.param_count() == b.param_count()


def test_registry_holds_all_thirteen():
    from repro.config import list_archs
    assert len(_ARCHS) == 13
    assert set(_ARCHS) == set(list_archs())


def test_xlstm_builds_3_65b_parameters():
    """The JAX package's xlstm-1.3b has full d_in x d_in q/k/v (the
    paper's are block-diagonal): 3.65 B parameters; the port reproduces
    it."""
    n = get_arch("xlstm-1.3b").param_count()
    assert 3.6e9 < n < 3.7e9


@pytest.mark.parametrize("arch", _ARCHS)
def test_build_model_serves_every_config(arch):
    """Every carried config builds, initialises, prefills and decodes a
    step at its reduced shape (no family raises any more)."""
    from repro_torch.launch.serve import reduced
    cfg = reduced(get_arch(arch)).scaled(dtype="float32")
    m = api.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((2, 5), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((2, cfg.vlm.n_img_tokens,
                                             cfg.d_model))
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros((2, cfg.encdec.n_audio_frames,
                                             cfg.d_model))
    n = 5 + (cfg.vlm.n_img_tokens if cfg.family == "vlm" else 0)
    logits, cache = m.prefill(params, batch, n + 2)
    assert logits.shape == (2, cfg.vocab_padded())
    step, _ = m.decode_step(params, cache, torch.ones((2, 1), dtype=torch.int32),
                            n)
    assert torch.isfinite(step).all()
    assert (m.decode_step_paged is None) == (cfg.family in ("ssm", "hybrid",
                                                            "audio"))


@pytest.mark.parametrize("case", list(CASES))
def test_bridged_tree_has_the_ports_structure(case):
    jcfg, tcfg, jp, tp, _, _ = _setup(case)
    own = api.build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert _shapes(tp) == _shapes(own)


# ---------------------------------------------------------------------------
# The chunked scans and the causal conv
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, Bb=2, T=20, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    x = _rand(rng, (Bb, T, H, P))
    dt = np.log1p(np.exp(_rand(rng, (Bb, T, H)))).astype(np.float32)
    A = -np.exp(_rand(rng, (H,), 0.5))
    return x, dt, A, _rand(rng, (Bb, T, N)), _rand(rng, (Bb, T, N)), \
        _rand(rng, (Bb, H, P, N))


@pytest.mark.parametrize("chunk,T", [(4, 16), (8, 20), (128, 12), (5, 23)])
def test_ssd_chunked_matches_reference_function(chunk, T):
    """The port's ssd_chunked against the JAX package's on the same numpy
    inputs (a T that is not a multiple of the chunk takes dt = 0 padding),
    with and without a carried state."""
    x, dt, A, Bm, Cm, st = _ssd_inputs(chunk + T, T=T)
    for init in (None, st):
        yj, sj = jmamba2.ssd_chunked(*(jnp.asarray(a) for a in
                                       (x, dt, A, Bm, Cm)), chunk,
                                     None if init is None else
                                     jnp.asarray(init))
        yt, s_t = tmamba2.ssd_chunked(*(torch.from_numpy(a) for a in
                                        (x, dt, A, Bm, Cm)), chunk,
                                      None if init is None else
                                      torch.from_numpy(init))
        _close(yt, yj, STATE_TOL)
        _close(s_t, sj, STATE_TOL)


@pytest.mark.parametrize("chunk", [1, 3, 4, 7, 32])
def test_ssd_chunked_matches_own_reference(chunk):
    """Chunked == the step-by-step oracle inside the port, over chunk
    sizes that do and do not divide T = 21."""
    x, dt, A, Bm, Cm, st = (torch.from_numpy(a) for a in _ssd_inputs(chunk,
                                                                      T=21))
    for init in (None, st):
        yc, sc = tmamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
        yr, sr = tmamba2.ssd_reference(x, dt, A, Bm, Cm, init)
        _close(yc, yr, STATE_TOL)
        _close(sc, sr, STATE_TOL)


def _mlstm_inputs(seed, Bb=2, T=20, nh=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, (Bb, T, nh, dh)) for _ in range(3))
    ilog = _rand(rng, (Bb, T, nh))
    flog = -np.log1p(np.exp(-(_rand(rng, (Bb, T, nh)) + 2.0))) \
        .astype(np.float32)
    return q, k, v, ilog, flog


def _mlstm_state(seed, Bb=2, nh=2, dh=8):
    rng = np.random.default_rng(seed)
    return {"C": _rand(rng, (Bb, nh, dh, dh)), "n": _rand(rng, (Bb, nh, dh)),
            "m": _rand(rng, (Bb, nh))}


def _true_state(st):
    """The stabilized state's true C and n (C_hat exp(m), n_hat exp(m))."""
    C, n, m = (np.asarray(st[k], np.float64) for k in ("C", "n", "m"))
    return C * np.exp(m)[..., None, None], n * np.exp(m)[..., None]


@pytest.mark.parametrize("chunk,T", [(4, 16), (8, 20), (128, 12), (6, 23)])
def test_mlstm_chunked_matches_reference_function(chunk, T):
    """The port's mlstm_chunked against the JAX package's on the same
    numpy inputs (a ragged T pads ilog with NEG), with and without a
    carried state: h and the stabilized state within 1e-5."""
    ins = _mlstm_inputs(chunk + T, T=T)
    for init in (None, _mlstm_state(T)):
        hj, sj = jxlstm.mlstm_chunked(
            *(jnp.asarray(a) for a in ins), chunk,
            None if init is None else {k: jnp.asarray(v)
                                       for k, v in init.items()})
        ht, s_t = txlstm.mlstm_chunked(
            *(torch.from_numpy(a) for a in ins), chunk,
            None if init is None else {k: torch.from_numpy(v)
                                       for k, v in init.items()})
        _close(ht, hj, STATE_TOL)
        for name in ("C", "n", "m"):
            _close(s_t[name], sj[name], STATE_TOL)


@pytest.mark.parametrize("chunk", [1, 3, 4, 7, 32])
def test_mlstm_chunked_matches_own_reference(chunk):
    """Chunked == the step-by-step oracle inside the port (h, and the true
    C and n), over chunk sizes that do and do not divide T = 21; two
    chunked calls carrying the state == one call."""
    q, k, v, i, f = (torch.from_numpy(a) for a in _mlstm_inputs(chunk, T=21))
    hc, sc = txlstm.mlstm_chunked(q, k, v, i, f, chunk)
    hr, sr = txlstm.mlstm_reference(q, k, v, i, f)
    _close(hc, hr, 2e-4)
    for a, b in zip(_true_state(sc), _true_state(sr)):
        _close(a, b, 2e-3)
    h1, s1 = txlstm.mlstm_chunked(q[:, :9], k[:, :9], v[:, :9], i[:, :9],
                                  f[:, :9], chunk)
    h2, _ = txlstm.mlstm_chunked(q[:, 9:], k[:, 9:], v[:, 9:], i[:, 9:],
                                 f[:, 9:], chunk, s1)
    _close(torch.cat([h1, h2], 1), hc, 2e-4)


def test_slstm_scan_matches_reference():
    """The sLSTM block (its loop over time, h carried in the model dtype)
    and its end state against the JAX package's, from a zero and from a
    carried state."""
    jcfg, tcfg, jp, tp, _, _ = _setup("xlstm-1.3b-mixed")
    rng = np.random.default_rng(3)
    x = _rand(rng, (B, 9, jcfg.d_model))
    jsp = jax.tree.map(lambda a: a[0], jp["slstm"])
    tsp = tp["slstm"][0]
    yj, sj = jxlstm.slstm_block(jcfg, jsp, jnp.asarray(x), collect_state=True)
    yt, s_t = txlstm.slstm_block(tcfg, tsp, torch.from_numpy(x))
    _close(yt, yj, STATE_TOL)
    for a, b in zip(s_t, sj):
        _close(a, b, STATE_TOL)
    x2 = _rand(rng, (B, 4, jcfg.d_model))
    yj, sj2 = jxlstm.slstm_block(jcfg, jsp, jnp.asarray(x2), state=sj,
                                 collect_state=True)
    yt, st2 = txlstm.slstm_block(tcfg, tsp, torch.from_numpy(x2), state=s_t)
    _close(yt, yj, STATE_TOL)
    for a, b in zip(st2, sj2):
        _close(a, b, STATE_TOL)


@pytest.mark.parametrize("T", [1, 5])
def test_causal_conv_with_carried_state_bitwise(monkeypatch, T):
    """The causal conv's sum of shifted products and its new state are
    bitwise the JAX package's at float32, from a zero and from a carried
    state (the JAX side's SiLU switched off to read its sum); the SiLU of
    it within 1e-6."""
    rng = np.random.default_rng(T)
    w, x, st = _rand(rng, (4, 6)), _rand(rng, (2, T, 6)), _rand(rng, (2, 3, 6))
    for init in (None, st):
        jinit = None if init is None else jnp.asarray(init)
        tinit = None if init is None else torch.from_numpy(init)
        act_j, _ = jmamba2._causal_conv(jnp.asarray(w), jnp.asarray(x), jinit)
        act_t, _ = tmamba2._causal_conv(torch.from_numpy(w),
                                        torch.from_numpy(x), tinit)
        _close(act_t, act_j, 1e-6)
        with monkeypatch.context() as m:
            m.setattr(jmamba2.jax.nn, "silu", lambda a: a)
            sum_j, new_j = jmamba2._causal_conv(jnp.asarray(w),
                                                jnp.asarray(x), jinit)
        sum_t, new_t = tmamba2._conv_sum(torch.from_numpy(w),
                                         torch.from_numpy(x), tinit)
        np.testing.assert_array_equal(sum_t.numpy(), np.asarray(sum_j))
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------


def test_attention_block_and_cross_attention_match_reference():
    """attention_block (causal and bidirectional), cross_kv and
    cross_attend against the JAX package's on Whisper's reduced layer."""
    jcfg, tcfg, jp, tp, _, _ = _setup("whisper-tiny")
    rng = np.random.default_rng(4)
    x, enc = _rand(rng, (B, 7, jcfg.d_model)), _rand(rng, (B, 9, jcfg.d_model))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32)[None], (B, 7))
    ja = jax.tree.map(lambda a: a[0], jp["dec_layers"])
    ta = tp["dec_layers"][0]
    for bidir in (False, True):
        want = jcommon.attention_block(ja["attn"], jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), bidirectional=bidir)
        got = tcommon.attention_block(ta["attn"], tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()),
                                      bidirectional=bidir)
        _close(got, want)
    from repro.models import whisper as jwhisper
    jk, jv = jwhisper._cross_kv(ja["xattn"], jcfg, jnp.asarray(enc))
    tk, tv = tcommon.cross_kv(ta["xattn"], tcfg, torch.from_numpy(enc))
    _close(tk, jk)
    _close(tv, jv)
    _close(tcommon.cross_attend(ta["xattn"], tcfg, torch.from_numpy(x), tk, tv),
           jwhisper._cross_attend(ja["xattn"], jcfg, jnp.asarray(x), jk, jv))


@pytest.mark.parametrize("pos", [3, 17, 20])
def test_decode_attention_plain_matches_reference(pos):
    """The plain one-token decode attention (the path these families are
    served on) against the JAX package's ``decode_attention`` without
    kernels, on a random slot cache of 18 slots (pos 20 wraps)."""
    jcfg, tcfg, jp, tp, _, _ = _setup("whisper-tiny")
    rng = np.random.default_rng(pos)
    W, nkv, dh = 18, jcfg.n_kv_heads, jcfg.d_head
    x = _rand(rng, (B, 1, jcfg.d_model))
    ck, cv = _rand(rng, (B, W, nkv, dh)), _rand(rng, (B, W, nkv, dh))
    ja = jax.tree.map(lambda a: a[1], jp["dec_layers"])["attn"]
    out_j, kj, vj = jcommon.decode_attention(ja, jcfg, jnp.asarray(x),
                                             jnp.asarray(ck), jnp.asarray(cv),
                                             jnp.int32(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out_t = tcommon.decode_attention_plain(tp["dec_layers"][1]["attn"], tcfg,
                                           torch.from_numpy(x), tk, tv, pos)
    _close(out_t, out_j)
    _close(tk, kj)
    _close(tv, vj)


# ---------------------------------------------------------------------------
# Whole models against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits(case, bits):
    """Prefill logits and cache, then four greedy decode steps: logits
    within 1e-4 of repro's, the cache after prefill and after each decode
    step within 1e-5 of each leaf's scale (through the cache bridge), the
    same greedy tokens."""
    jcfg, tcfg, jp, tp, toks, audio = _trees(case, bits)
    jm, tm = japi.build_model(jcfg), api.build_model(tcfg)
    W = S + 6
    jb, tb = _batches(toks, audio)
    lj, cj = jm.prefill(jp, jb, W)
    lt, ct = tm.prefill(tp, tb, W)
    _close(lt, lj)
    _cache_close(tcfg, ct, cj)
    nxt = np.asarray(jnp.argmax(lj[:, :jcfg.vocab], -1)).astype(np.int32)
    pos = S
    for _ in range(4):
        dj, cj = jm.decode_step(jp, cj, jnp.asarray(nxt[:, None]),
                                jnp.int32(pos))
        dt, ct = tm.decode_step(tp, ct, torch.from_numpy(nxt[:, None]), pos)
        _close(dt, dj)
        _cache_close(tcfg, ct, cj)
        want = np.asarray(jnp.argmax(dj[:, :jcfg.vocab], -1))
        np.testing.assert_array_equal(
            torch.argmax(dt[:, :tcfg.vocab], -1).numpy(), want)
        nxt, pos = want.astype(np.int32), pos + 1


@pytest.mark.parametrize("case", ["xlstm-1.3b-mixed", "zamba2-7b-mixed",
                                  "whisper-tiny"])
def test_forward_and_loss_match_reference(case):
    jcfg, tcfg, jp, tp, toks, audio = _setup(case)
    labels = np.roll(toks, -1, axis=1)
    jb, tb = _batches(toks, audio)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    jm, tm = japi.build_model(jcfg), api.build_model(tcfg)
    (jl, _), (tl, tmet) = jm.loss_fn(jp, jb), tm.loss_fn(tp, tb)
    _close(tl, jl)
    assert float(tmet["loss"]) == float(tl)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_bridged_quantized_slices_equal_own_quantization(case, bits):
    """The bridge's per-layer slices of the JAX package's quantized
    stacked leaves (q, scales) are bitwise the port's quantization of each
    layer: both reduce over axis -2 only."""
    jcfg, tcfg, jp, tp, _, _ = _setup(case)
    got = bridge.from_jax_params(jax.device_get(jptq.quantize_tree(jp, bits)),
                                 device="cpu")
    want = tptq.quantize_tree(tp, bits)
    a = [x for x in tptq.tree_leaves(got) if isinstance(x, tptq.QTensor)]
    b = [x for x in tptq.tree_leaves(want) if isinstance(x, tptq.QTensor)]
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x.q, y.q) and torch.equal(x.scale, y.scale)
        assert (x.bits, x.shape, x.dtype) == (y.bits, y.shape, y.dtype)


def test_reference_xlstm_init_draws_two_weights_from_one_key_f6():
    """F6, a fault of the JAX package's random init, shown on it alone:
    ``init_mlstm`` draws ``wi`` and ``wf`` from one key (``ks[6]``) and
    ``init_slstm`` draws ``ffn_w1`` and ``ffn_w3`` from one (``ks[4]``),
    so each pair is equal in every layer: the input and forget gates get
    the same pre-activation, the gated FFN's two branches the same input.
    The port's own init draws each weight apart; the parity tests above
    run on the bridged JAX weights, fault and all."""
    jcfg, tcfg, jp, _, _, _ = _setup("xlstm-1.3b-mixed")
    m, s = jp["mlstm"], jp["slstm"]
    assert np.array_equal(np.asarray(m["wi"]), np.asarray(m["wf"]))
    assert np.array_equal(np.asarray(s["ffn_w1"]), np.asarray(s["ffn_w3"]))
    own = api.build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert not torch.equal(own["mlstm"][0]["wi"], own["mlstm"][0]["wf"])
    assert not torch.equal(own["slstm"][0]["ffn_w1"],
                           own["slstm"][0]["ffn_w3"])

"""The port's transformer family (GQA, qk-norm, sliding window, int8 KV
cache, MoE, VLM) against ``repro.models``, at float32 on the reduced
configs of ``tests/conftest.py``.

The JAX side runs ``use_kernel=False`` on the dequantized tree (its Pallas
calls do not run on the CPU); the port runs its QTensor tree through the
kernels' plain versions, with decode attention through the kernel entry
points (``use_kernel``) and without.  Both get the same weights, bridged
from the JAX tree, and the same inputs, made with numpy from a seed."""
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
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import MoEConfig, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

NEW_ARCHS = ["deepseek-coder-33b", "mistral-large-123b", "qwen3-1.7b",
             "mixtral-8x22b", "granite-moe-1b-a400m", "internvl2-26b"]
B, S = 2, 12
TOL = 1e-4
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
          "d_ff", "vocab", "norm", "act", "qk_norm", "rope_theta",
          "sliding_window", "tie_embeddings", "dtype", "kv_bits")


def port_cfg(arch, **kw):
    """``reduced_cfg`` built from the port's own registry."""
    cfg = get_arch(arch).scaled(**REDUCTIONS[arch])
    if cfg.is_moe and cfg.moe.n_experts > 4:
        cfg = dataclasses.replace(
            cfg, moe=MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2)))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg.scaled(dtype="float32", **kw)


def jax_cfg(arch, **kw):
    return reduced_cfg(arch).scaled(dtype="float32", **kw)


def _n_img(cfg):
    return cfg.vlm.n_img_tokens if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = jax_cfg(arch)
    p = jtr.init_params(cfg, jax.random.key(1))
    tp = bridge.from_jax_params(jax.device_get(p), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    img = (rng.standard_normal((B, _n_img(cfg), cfg.d_model)) * 0.02) \
        .astype(np.float32)
    return cfg, p, tp, toks, img


def _batches(cfg, toks, img):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        jb["patch_embeds"] = jnp.asarray(img)
        tb["patch_embeds"] = torch.from_numpy(img)
    return jb, tb


def _trees(arch, bits):
    cfg, p, tp, toks, img = _setup(arch)
    if bits == 0:
        return cfg, p, tp, toks, img
    return cfg, jptq.dequantize_tree(jptq.quantize_tree(p, bits)), \
        tptq.quantize_tree(tp, bits), toks, img


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of a param tree's leaves."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: None if tree is None else (tuple(tree.shape), tree.dtype)}


# ---------------------------------------------------------------------------
# Configs and the model factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_copy_matches_reference(arch):
    from repro.config import get_arch as jget_arch
    a, b = jget_arch(arch), get_arch(arch)
    for f in FIELDS + ("source",):
        assert getattr(a, f) == getattr(b, f), (arch, f)
    assert (a.moe.n_experts, a.moe.top_k) == (b.moe.n_experts, b.moe.top_k)
    assert (a.vlm is None) == (b.vlm is None)
    if a.vlm is not None:
        assert a.vlm.n_img_tokens == b.vlm.n_img_tokens
    ra, rb = jax_cfg(arch), port_cfg(arch)
    for f in FIELDS:
        assert getattr(ra, f) == getattr(rb, f), (arch, f)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_build_model_serves_the_family(arch):
    cfg = port_cfg(arch)
    m = api.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    lp = params["layers"][0]
    assert ("moe" in lp) == cfg.is_moe and ("ffn" in lp) != cfg.is_moe
    assert ("q_norm" in lp["attn"]) == cfg.qk_norm
    if cfg.is_moe:
        E = cfg.moe.n_experts
        assert lp["moe"]["w1"].shape == (E, cfg.d_model, cfg.d_ff)
        assert lp["moe"]["router"].shape == (cfg.d_model, E)
    # the bridged JAX tree has the port's structure and shapes
    _, _, tp, _, _ = _setup(arch)
    assert _shapes(tp) == _shapes(params)


# ---------------------------------------------------------------------------
# Prefill, decode and greedy tokens against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits(arch, bits):
    """Prefill logits and cache, then three greedy decode steps: logits
    within 1e-4 of repro's and the same greedy tokens, decode attention
    through the kernel entry points and without.  A VLM's prefill holds
    its 256 image positions ahead of the text."""
    jcfg, jp, tp, toks, img = _trees(arch, bits)
    tcfg = port_cfg(arch)
    W = S + _n_img(jcfg) + 6
    jb, tb = _batches(jcfg, toks, img)
    lj, cj = jtr.prefill(jcfg, jp, jb, W)
    lt, ct = ttr.prefill(tcfg, tp, tb, W)
    _close(lt, lj)
    _close(ct[1]["k"], cj["k"][1])
    assert ct[0]["k"].shape[1] == cj["k"].shape[2]
    for use_kernel in (False, True):
        cache = _clone(ct)
        cjs = cj
        nxt = np.asarray(jnp.argmax(lj[:, :jcfg.vocab], -1)).astype(np.int32)
        pos = S + _n_img(jcfg)
        for _ in range(3):
            dj, cjs = jtr.decode_step(jcfg, jp, cjs, jnp.asarray(nxt[:, None]),
                                      jnp.int32(pos))
            dt, cache = ttr.decode_step(tcfg, tp, cache,
                                        torch.from_numpy(nxt[:, None]), pos,
                                        use_kernel=use_kernel)
            _close(dt, dj)
            _close(cache[0]["v"], cjs["v"][0])
            want = np.asarray(jnp.argmax(dj[:, :jcfg.vocab], -1))
            got = torch.argmax(dt[:, :tcfg.vocab], -1).numpy()
            np.testing.assert_array_equal(got, want)
            nxt, pos = want.astype(np.int32), pos + 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "internvl2-26b", "mixtral-8x22b"])
def test_loss_matches_reference(arch):
    """loss_fn: the cross-entropy plus 0.01 x the MoE aux loss; a VLM's
    image positions carry no LM loss."""
    jcfg, jp, tp, toks, img = _setup(arch)
    labels = np.roll(toks, -1, axis=1)
    jb, tb = _batches(jcfg, toks, img)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    (jl, jm) = jtr.loss_fn(jcfg, jp, jb)
    (tl, tm) = ttr.loss_fn(port_cfg(arch), tp, tb)
    _close(tl, jl)
    _close(tm["aux_loss"], jm["aux_loss"])
    assert (float(tm["aux_loss"]) > 0) == jcfg.is_moe


# ---------------------------------------------------------------------------
# qk-norm
# ---------------------------------------------------------------------------


def test_rms_head_norm_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 128)).astype(np.float32)
    w = rng.standard_normal((128,)).astype(np.float32)
    want = jcommon.rms_head_norm(jnp.asarray(x), jnp.asarray(w))
    got = tcommon.rms_head_norm(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want, 1e-6)


def test_qk_norm_keeps_the_fused_tier_off():
    tp = tptq.quantize_tree(_setup("qwen3-1.7b")[2], 8)
    cfg = port_cfg("qwen3-1.7b")
    assert cfg.qk_norm and cfg.d_head % 128 == 0
    assert ops.decode_kernel_tier(tp["layers"][0]["attn"], cfg) == "flash"


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, 3, 64)) * 3.0).astype(np.float32)
    x[0, 1, 2] = 0.0                  # an all-zero head takes scale 1
    x[1, 3, 0, :5] = 127.0 / 3.0      # exact halves of the round
    jx = jnp.asarray(x).astype(dtype)
    tx = bridge.to_tensor(np.asarray(jax.device_get(jx)), "cpu")
    jq, js = jcommon.quantize_kv(jx)
    tq, ts = tcommon.quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jd = jcommon.dequantize_kv(jq, js, jnp.float32)
    td = tcommon.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("pos", [5, 31, 35])
def test_kv8_decode_attention_matches_reference(monkeypatch, pos):
    """One layer's kv8 decode attention (quantize the token's k/v, write it
    and its scales at slot pos % W, dequantize, masked softmax, wo) over
    the slab and over pages: within 1e-4 of repro's kv8 path, the written
    int8 values and scales bitwise.  Both sides get the same q, k and v
    (their projections are patched to return them): a k or v that sits on
    a rounding edge of the int8 grid would otherwise quantize one step
    apart after float32 matmuls that sum in a different order, which moves
    the logits by about 1e-4 (``test_kv8_model_decode`` holds the model)."""
    cfg = port_cfg("qwen3-1.7b", kv_bits=8)
    jcfg = jax_cfg("qwen3-1.7b", kv_bits=8)
    _, p, tp, _, _ = _setup("qwen3-1.7b")
    jlp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["attn"])
    tlp = tp["layers"][0]["attn"]
    nkv, nh, dh, W, bt = cfg.n_kv_heads, cfg.n_heads, cfg.d_head, 32, 8
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    q = rng.standard_normal((B, 1, nh, dh)).astype(np.float32)
    k1, v1 = (rng.standard_normal((B, 1, nkv, dh)).astype(np.float32)
              for _ in range(2))
    cache = {"k": rng.integers(-128, 128, (B, W, nkv, dh)).astype(np.int8),
             "v": rng.integers(-128, 128, (B, W, nkv, dh)).astype(np.int8),
             "ks": rng.uniform(0.001, 0.03, (B, W, nkv)).astype(np.float32),
             "vs": rng.uniform(0.001, 0.03, (B, W, nkv)).astype(np.float32)}
    monkeypatch.setattr(jcommon, "qkv_proj", lambda *a, **k: tuple(
        jnp.asarray(t) for t in (q, k1, v1)))
    monkeypatch.setattr(tcommon, "qkv_proj", lambda *a, **k: tuple(
        torch.from_numpy(t) for t in (q, k1, v1)))
    jout, jc = jcommon.decode_attention_cache(
        jlp, jcfg, jnp.asarray(x), {n: jnp.asarray(v) for n, v in
                                    cache.items()}, jnp.int32(pos))
    tc = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    tout = tcommon.decode_attention_cache(tlp, cfg, torch.from_numpy(x), tc,
                                          pos)
    _close(tout, jout)
    for n in cache:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]), n)
    # the same cache as pages: each row's blocks on pages of its own
    nb = W // bt
    table = (2 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)
    pages = {n: np.zeros((2 + B * nb, bt) + v.shape[2:], v.dtype)
             for n, v in cache.items()}
    for n, v in cache.items():
        pages[n][2:] = v.reshape((B * nb, bt) + v.shape[2:])
    if pos >= W:
        return                      # the paged cache does not wrap
    jpo, jpg = jcommon.decode_attention_paged(
        jlp, jcfg, jnp.asarray(x), {n: jnp.asarray(v) for n, v in
                                    pages.items()}, jnp.asarray(table),
        jnp.int32(pos))
    tpg = {n: torch.from_numpy(v.copy()) for n, v in pages.items()}
    tpo = tcommon.decode_attention_paged(tlp, cfg, torch.from_numpy(x), tpg,
                                         torch.from_numpy(table), pos)
    np.testing.assert_array_equal(tpo.numpy(), tout.numpy())
    _close(tpo, jpo)
    for n in pages:
        np.testing.assert_array_equal(tpg[n].numpy(), np.asarray(jpg[n]), n)


@pytest.mark.parametrize("bits", [0, 8])
def test_kv8_model_decode(bits):
    """kv_bits=8 through the whole model: prefill logits within 1e-4 of
    repro's and its int8 cache at most one step of the grid from repro's
    (scales within 1e-5); four greedy decode steps from that cache give
    repro's tokens, the slab and the paged step bitwise equal; the tier is
    "kv8" and no kernel entry point runs."""
    _, p, tp, toks, _ = _setup("qwen3-1.7b")
    jcfg, tcfg = jax_cfg("qwen3-1.7b", kv_bits=8), port_cfg("qwen3-1.7b",
                                                            kv_bits=8)
    if bits:
        p, tp = jptq.dequantize_tree(jptq.quantize_tree(p, bits)), \
            tptq.quantize_tree(tp, bits)
    assert ops.decode_kernel_tier(tp["layers"][0]["attn"], tcfg) == "kv8"
    W = 32
    lj, cj = jtr.prefill(jcfg, p, {"tokens": jnp.asarray(toks)}, W)
    lt, ct = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, W)
    _close(lt, lj)
    assert set(ct[0]) == {"k", "v", "ks", "vs"}
    assert ct[0]["k"].dtype == torch.int8
    for name in ("k", "v"):
        got, want = ct[1][name].numpy(), np.asarray(cj[name][1])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        _close(ct[1][name + "s"], cj[name + "s"][1], 1e-5)
    bt = 8
    pages = {n: torch.zeros((tcfg.n_layers, 2 + B * W // bt, bt)
                            + tuple(leaf.shape[2:]), dtype=leaf.dtype)
             for n, leaf in ct[0].items()}
    table = torch.arange(2, 2 + B * W // bt, dtype=torch.int32).reshape(B, -1)
    for n in pages:
        for l, layer in enumerate(ct):
            pages[n][l, 2:] = layer[n].reshape((B * W // bt, bt)
                                               + tuple(layer[n].shape[2:]))
    slab = _clone(ct)
    nxt = np.asarray(jnp.argmax(lj[:, :jcfg.vocab], -1)).astype(np.int32)
    ops.reset_launch_counts()
    for pos in range(S, S + 4):
        dj, cj = jtr.decode_step(jcfg, p, cj, jnp.asarray(nxt[:, None]),
                                 jnp.int32(pos))
        tok = torch.from_numpy(nxt[:, None])
        ds, slab = ttr.decode_step(tcfg, tp, slab, tok, pos)
        dpg, pages = ttr.decode_step_paged(tcfg, tp, pages, table, tok, pos)
        np.testing.assert_array_equal(dpg.numpy(), ds.numpy())
        nxt = np.asarray(jnp.argmax(dj[:, :jcfg.vocab], -1)).astype(np.int32)
        np.testing.assert_array_equal(
            torch.argmax(ds[:, :tcfg.vocab], -1).numpy(), nxt)
    assert not any(ops.launch_counts().values())


def test_kv8_init_cache_and_arena_leaves():
    cfg = port_cfg("qwen3-1.7b", kv_bits=8)
    cache = ttr.init_cache(cfg, 2, 24, "cpu")
    jc = jtr.init_cache(jax_cfg("qwen3-1.7b", kv_bits=8), 2, 24)
    assert set(cache[0]) == set(jc)
    for n, leaf in cache[0].items():
        assert tuple(leaf.shape) == tuple(jc[n].shape[1:]), n
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jc[n][0]))


# ---------------------------------------------------------------------------
# Sliding window
# ---------------------------------------------------------------------------


def test_sliding_window_wraps_like_reference():
    """Mixtral at window 16 (MoE and SWA together): the cache holds 16
    slots whatever the context; past position 16 each step writes slot
    pos % 16 and reads min(pos + 1, 16) slots, as repro does."""
    jcfg, p, tp, toks, _ = _setup("mixtral-8x22b")
    tcfg = port_cfg("mixtral-8x22b")
    assert tcfg.sliding_window == 16 and tcfg.is_moe
    assert ttr.cache_capacity(tcfg, 64) == jtr.cache_capacity(jcfg, 64) == 16
    lj, cj = jtr.prefill(jcfg, p, {"tokens": jnp.asarray(toks)}, 64)
    lt, ct = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 64)
    assert ct[0]["k"].shape[1] == 16
    _close(lt, lj)
    nxt = np.asarray(jnp.argmax(lj[:, :jcfg.vocab], -1)).astype(np.int32)
    for pos in range(S, S + 10):            # wraps at 16
        dj, cj = jtr.decode_step(jcfg, p, cj, jnp.asarray(nxt[:, None]),
                                 jnp.int32(pos))
        dt, ct = ttr.decode_step(tcfg, tp, ct, torch.from_numpy(nxt[:, None]),
                                 pos)
        _close(dt, dj)
        _close(ct[1]["k"], cj["k"][1])
        nxt = np.asarray(jnp.argmax(dj[:, :jcfg.vocab], -1)).astype(np.int32)


def test_sliding_window_prefill_longer_than_window():
    """A prompt longer than the window: the windowed causal mask in
    prefill, and only the last 16 positions kept, at slot p % 16."""
    jcfg, p, tp, _, _ = _setup("mixtral-8x22b")
    toks = np.random.default_rng(9).integers(
        1, jcfg.vocab, size=(B, 27)).astype(np.int32)
    lj, cj = jtr.prefill(jcfg, p, {"tokens": jnp.asarray(toks)}, 40)
    lt, ct = ttr.prefill(port_cfg("mixtral-8x22b"), tp,
                         {"tokens": torch.from_numpy(toks)}, 40)
    _close(lt, lj)
    for l in range(jcfg.n_layers):
        _close(ct[l]["v"], cj["v"][l])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _jax_route(probs, K, C):
    """The routing lines of repro's ``moe_apply``
    (``src/repro/models/common.py:572-590``), on their own."""
    gate_w, gate_idx = jax.lax.top_k(probs, K)
    gate_w = gate_w / jnp.sum(gate_w, axis=-1, keepdims=True)
    flat_idx = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_idx, probs.shape[-1], dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_in_e, flat_idx[:, None], axis=1)[:, 0]
    return gate_w, gate_idx, flat_idx, pos, pos < C


@pytest.mark.parametrize("T,E,K,cf", [(16, 4, 2, 1.25), (64, 32, 8, 1.25),
                                      (40, 8, 2, 0.5), (8, 32, 8, 1.25)])
def test_moe_routing_integers_exact(T, E, K, cf):
    """Top-k ids, capacity slots and dropped assignments equal repro's
    exactly; the renormalised weights within 1e-6."""
    rng = np.random.default_rng(T + E)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    # bf16-rounded logits, as the router's are: ties are real
    logits = np.array(jnp.asarray(logits).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    jprobs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    tprobs = torch.softmax(torch.from_numpy(logits), dim=-1)
    C = max(int(np.ceil(T * K / E * cf)), 1)
    want = _jax_route(jprobs, K, C)
    got = tcommon.moe_route(tprobs, K, C)
    for name, g, w in zip(("gate_idx", "flat_idx", "pos", "keep"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    _close(got[0], want[0], 1e-6)
    if cf < 1:
        assert not bool(got[4].all())        # some assignments dropped


def test_moe_tie_puts_the_lower_expert_first():
    probs = np.full((3, 8), 0.125, np.float32)
    probs[1] = [0.1, 0.2, 0.2, 0.05, 0.2, 0.1, 0.1, 0.05]
    probs[2, 5] = probs[2, 2] = 0.2
    want = jax.lax.top_k(jnp.asarray(probs), 3)[1]
    got = tcommon.moe_route(torch.from_numpy(probs), 3, 4)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [0, 1, 2] and got[1].tolist() == [1, 2, 4]
    assert got[2].tolist() == [2, 5, 0]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_apply_matches_reference(arch, cf):
    """The whole layer: dispatch, expert FFN and the fixed-order combine
    within 1e-6 of repro's; the aux loss too; also with assignments
    dropped (capacity factor 0.5)."""
    jcfg, p, tp, _, _ = _setup(arch)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, jcfg.d_model)).astype(np.float32)
    jo, ja = jcommon.moe_apply(jax.tree_util.tree_map(
        lambda a: a[0], p["layers"]["moe"]), jcfg, jnp.asarray(x), cf)
    to, ta = tcommon.moe_apply(tp["layers"][0]["moe"], port_cfg(arch),
                               torch.from_numpy(x), cf, with_aux=True)
    _close(to, jo, 1e-6)
    _close(ta, ja, 1e-6)


# ---------------------------------------------------------------------------
# VLM and F5
# ---------------------------------------------------------------------------


def test_vlm_decode_overwrites_a_prompt_slot_f5():
    """F5, a fault of the reference, reproduced by the port.  The engine's
    prompt pass holds n_img + s_max positions, but its cache has s_max +
    n_max slots, so only the last s_max + n_max positions survive; decode
    step 0 then runs at position s_max, not n_img + s_max: it overwrites
    slot s_max, which holds a prompt position, with rope at s_max."""
    s_max, n_max = 16, 8
    jcfg, p, tp, _, _ = _setup("internvl2-26b")
    tcfg = port_cfg("internvl2-26b")
    je = jeng.ServingEngine(jcfg, params=p, batch_capacity=B, s_max=s_max,
                            n_max=n_max, use_kernel=False)
    te = teng.ServingEngine(tcfg, params=tp, batch_capacity=B, s_max=s_max,
                            n_max=n_max, device="cpu")
    n_img, W = jcfg.vlm.n_img_tokens, s_max + n_max
    assert n_img + s_max > je.cache_len == te.cache_len == W
    # the prompt position that slot s_max holds after the prompt pass
    kept = range(n_img + s_max - W, n_img + s_max)
    (held,) = [q for q in kept if q % W == s_max]
    assert held >= n_img                     # a text position of the prompt
    jtok, _, _, _ = je._pad_and_ship([[5, 6, 7], list(range(1, s_max + 1))],
                                     None)
    toks = np.array(jtok["tokens"])
    jcur, jcache = je._prefill(je.params, jtok)
    tcur, tcache = te._prefill(te.params, torch.from_numpy(toks))
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    before = np.asarray(jcache["k"][:, :, s_max])
    assert np.abs(before).max() > 0
    _close(tcache[0]["k"][:, s_max], before[0])
    jlog, jcache = je._decode(je.params, jcache, jcur[:, None],
                              jnp.int32(s_max))
    tlog, tcache = te.model.decode_step(te.params, tcache, tcur[:, None],
                                        s_max, use_kernel=False)
    _close(tlog, jlog)
    after = np.asarray(jcache["k"][:, :, s_max])
    assert np.abs(after - before).max() > 1e-3      # the prompt's k is gone
    _close(tcache[0]["k"][:, s_max], after[0])
    # the new token's k took rope at s_max, not at its place n_img + s_max
    lp = tp["layers"][0]
    h = tcommon.apply_norm(tcfg.norm, lp["norm1"], tp["embed"][tcur[:, None]])
    for pos, same in ((s_max, True), (n_img + s_max, False)):
        k1 = tcommon.qkv_proj(lp["attn"], tcfg, h, torch.full(
            (B, 1), pos, dtype=torch.int32))[1][:, 0]
        assert torch.allclose(k1, tcache[0]["k"][:, s_max],
                              atol=1e-6) == same


def test_vlm_engine_matches_jax_engine():
    """Greedy tokens of the VLM engine (zero patch embeddings, as repro's
    engine feeds) equal the JAX engine's, at float and W8."""
    jcfg, p, tp, _, _ = _setup("internvl2-26b")
    kw = dict(batch_capacity=2, s_max=16, n_max=6)
    prompts = [[5, 6, 7, 8], list(range(20, 36))]
    for bits in (0, 8):
        je = jeng.ServingEngine(jcfg, params=p, quant_bits=bits, **kw)
        te = teng.ServingEngine(port_cfg("internvl2-26b"), params=tp,
                                quant_bits=bits, device="cpu", **kw)
        want = je.generate(prompts, [6, 4])
        got = te.generate(prompts, [6, 4])
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.lengths, want.lengths)

"""The decode-glue kernels' plain versions and where the model routes them
(CPU; the kernels themselves are held to these in ``tests/
test_torch_cuda.py``).

``add_norm`` (a decode layer's residual add and the norm after it) and
``rope_qk_write`` (rope on one token's q and k, and its k and v written
into a slab or a paged cache) replace op chains of the decode step.  On
the CPU their plain versions ARE those chains, bitwise: for the three norm
kinds with and without a weight and without the add, and for rope at
d_head 32-128 and G 1-4 with slab and paged writes (only the token's slot
or page changes).  A decode step on the CPU takes the plain versions and
equals, bitwise, the step as the op chains ran it (BLOOM-3B's layernorm,
BLOOM-7B1's fused tier, qwen3's rmsnorm with qk-norm at G = 2, OLMo's
nonparam_ln, granite's MoE), slab and paged.  The prefill and training
keep their op chains (``apply_norm``, ``apply_rope``, ``qkv_proj`` run on
meta tensors, where a kernel route raises, and under autograd).  A numpy
model of add_norm's fixed-order block sum lands within one bf16 ulp of
the chain at the served widths, and the block-width plan covers every row
up to 16384.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import decode_glue as dg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.serving import trace  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
KINDS = ["layernorm", "nonparam_ln", "rmsnorm"]


def _randn(shape, dtype, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dtype)


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# -- the plain versions are the op chains ---------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_y", [True, False], ids=["add", "no_add"])
@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
@pytest.mark.parametrize("kind", KINDS)
def test_add_norm_plain_is_the_op_chain(kind, weighted, with_y, dtype):
    D = 2560
    x = _randn((8, 1, D), dtype, 0, shift=0.3)
    y = _randn((8, 1, D), dtype, 1, scale=2.0) if with_y else None
    w = _randn((D,), dtype, 2, scale=0.1, shift=1.0) if weighted else None
    x_new, h = ops.add_norm(x, y, w, kind)
    want_x = x + y if with_y else x
    _bitwise(x_new, want_x)
    _bitwise(h, common.apply_norm(kind, w, want_x))
    # the model's entry, kernel route and op chain alike on the CPU
    for use_kernel in (True, False):
        x2, h2 = common.add_norm(kind, w, x, y, use_kernel)
        _bitwise(x2, want_x)
        _bitwise(h2, h)


def _rope_case(B, nh, nkv, dh, W, dtype, seed):
    q = _randn((B, 1, nh, dh), dtype, seed)
    k = _randn((B, 1, nkv, dh), dtype, seed + 1)
    v = _randn((B, 1, nkv, dh), dtype, seed + 2)
    ck = _randn((B, W, nkv, dh), dtype, seed + 3)
    cv = _randn((B, W, nkv, dh), dtype, seed + 4)
    return q, k, v, ck, cv


def _pages_of(cache, table, bt, tail=None):
    """The slab cache (B, W, nkv, dh) as arena pages through ``table``
    (B, n_b), in a wider tail (nkv', dh') if given; returns the arena and
    its leading-corner view."""
    B, W, nkv, dh = cache.shape
    n_b = W // bt
    nkv_t, dh_t = tail or (nkv, dh)
    arena = torch.zeros((B * n_b + 2, bt, nkv_t, dh_t), dtype=cache.dtype)
    arena[table.long(), :, :nkv, :dh] = cache.reshape(B, n_b, bt, nkv, dh)
    return arena, arena[..., :nkv, :dh]


ROPE_CASES = [(1, 80, 0), (1, 80, 63), (4, 32, 64), (2, 128, 17),
              (1, 64, 127)]


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,dh,pos", ROPE_CASES)
def test_rope_qk_write_plain_is_the_op_chain(G, dh, pos, dtype, paged,
                                             use_rope):
    B, nkv, W, bt = 3, 2, 128, 16
    q, k, v, ck, cv = _rope_case(B, G * nkv, nkv, dh, W, dtype, pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32)
    want_q = common.apply_rope(q, positions, 1e4) if use_rope else q
    want_k = common.apply_rope(k, positions, 1e4) if use_rope else k
    slot = pos % W
    want_ck, want_cv = ck.clone(), cv.clone()
    want_ck[:, slot] = want_k[:, 0]
    want_cv[:, slot] = v[:, 0]
    dp = ops.decode_pos(torch.tensor(pos, dtype=torch.int32), "cpu")
    if not paged:
        got_q = ops.rope_qk_write(q, k, v, dp, 1e4, ck, cv,
                                  use_rope=use_rope)
        _bitwise(ck, want_ck)
        _bitwise(cv, want_cv)
    else:
        rng = np.random.default_rng(pos)
        table = torch.from_numpy((2 + rng.permutation(B * W // bt)).reshape(
            B, W // bt).astype(np.int32))
        (ak, kc), (av, vc) = (_pages_of(c, table, bt, tail=(3, dh + 16))
                              for c in (ck, cv))
        before_k, before_v = ak.clone(), av.clone()
        got_q = ops.rope_qk_write(q, k, v, dp, 1e4, kc, vc, table,
                                  use_rope=use_rope)
        for arena, before, want in ((ak, before_k, want_ck),
                                    (av, before_v, want_cv)):
            _bitwise(_gather(arena[..., :nkv, :dh], table), want)
            changed = (arena != before).any(dim=(2, 3))      # (P, bt)
            page = table[:, pos // bt].long()
            mask = torch.zeros_like(changed)
            mask[page, pos % bt] = True
            assert not (changed & ~mask).any()       # only the token's slot
    _bitwise(got_q, want_q)


def _gather(pages, table):
    from repro_torch.kernels.flash_decode import gather_pages
    return gather_pages(pages, table)


def test_rope_freqs_and_the_fused_tier_rows_are_the_chain():
    for dh, theta in ((80, 1e4), (128, 1e6), (64, 5e5)):
        _bitwise(dg.rope_freqs(dh, theta), common.rope_freqs(dh, theta))
        table = dg.rope_table(dh, theta, "cpu")
        assert dg.rope_table(dh, theta, "cpu") is table    # made once
        _bitwise(table, common.rope_freqs(dh, theta))
        cos, sin = ops._rope_rows(37, dh, theta, "cpu")
        ang = common.rope_freqs(dh, theta) * 37.0
        _bitwise(cos[0], torch.cos(ang))
        _bitwise(sin[0], torch.sin(ang))


# -- the decode step on the CPU: the plain versions, bitwise the chains ---


def _chain_attention(p, cfg, x, ck, cv, pos, table=None):
    """The unfused decode attention as the op chains ran it: ``qkv_proj``'s
    rope, the write (``cache_write`` on a slab, ``index_put_`` into pages),
    the plain flash decode and wo."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32)
    q, k1, v1 = common.qkv_proj(p, cfg, x, positions)
    if table is None:
        common.cache_write(((ck, k1), (cv, v1)), pos)
        out = ops.flash_decode(q[:, 0], ck, cv, min(pos + 1, ck.shape[1]))
    else:
        bt = ck.shape[1]
        page = table[:, pos // bt].long()
        off = torch.full((B,), pos % bt, dtype=torch.long)
        ck.index_put_((page, off), k1[:, 0].to(ck.dtype))
        cv.index_put_((page, off), v1[:, 0].to(cv.dtype))
        out = ops.flash_decode_paged(q[:, 0], ck, cv, table, pos + 1)
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return common.mm(out, p["wo"])


def _chain_step(cfg, params, attend, tokens):
    """The decode step as the op chains ran it: apply_norm before each
    block, x + block after it, the final norm, the unembedding."""
    x = transformer._table(params)[tokens]
    for l, lp in enumerate(params["layers"]):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        x = x + attend(l, lp, h)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + transformer._ffn(cfg, lp, h)[0]
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return transformer._unembed(cfg, params, x)[:, 0]


STEP_ARCHS = {
    "bloom-3b": dict(n_heads=4, n_kv_heads=4),
    "bloom-7b1": dict(d_model=256, n_heads=2, n_kv_heads=2),    # fused tier
    "qwen3-1.7b": dict(n_heads=4, n_kv_heads=2),                # G = 2
    "olmo-1b": dict(n_heads=4, n_kv_heads=4),
    "granite-moe-1b-a400m": dict(n_heads=4, n_kv_heads=2),
}


def _step_engine(arch):
    dims = dict(n_layers=2, d_model=128, d_ff=256, vocab=256)
    dims.update(STEP_ARCHS[arch])
    cfg = get_arch(arch).scaled(**dims, dtype="bfloat16")
    eng = ServingEngine(cfg, batch_capacity=4, s_max=24, n_max=8,
                        quant_bits=8, seed=3, device="cpu")
    params = eng.params_for(8)
    # norm weights away from one, so a weight that is skipped shows
    gen = torch.Generator().manual_seed(7)
    for lp in params["layers"]:
        for name in ("norm1", "norm2"):
            if lp[name] is not None:
                lp[name] = (1 + 0.2 * torch.randn(lp[name].shape,
                                                  generator=gen)).to(
                    lp[name].dtype)
    return eng, params


@pytest.mark.parametrize("pos", [0, 13, 31])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_decode_step_equals_the_op_chain_step(arch, paged, pos):
    eng, params = _step_engine(arch)
    cfg = eng.cfg
    if arch == "bloom-7b1":
        assert eng.decode_tier(8) == "fused"
    B, W, nkv, dh = 4, eng.cache_len, cfg.n_kv_heads, cfg.d_head
    rng = np.random.default_rng(pos)
    cache = [{n: _randn((B, W, nkv, dh), torch.bfloat16, 10 * l + i)
              for i, n in enumerate(("k", "v"))} for l in range(cfg.n_layers)]
    tokens = torch.from_numpy(rng.integers(1, 256, (B, 1)))
    pos_t = torch.tensor(pos, dtype=torch.int32)
    fused = ops.fusable_decode(params["layers"][0]["attn"], cfg)
    if not paged:
        want_cache = [{n: t.clone() for n, t in c.items()} for c in cache]

        def attend(l, lp, h):
            if fused:
                return common.decode_attention_cache(lp["attn"], cfg, h,
                                                     want_cache[l], pos)
            return _chain_attention(lp["attn"], cfg, h, want_cache[l]["k"],
                                    want_cache[l]["v"], pos)
        want = _chain_step(cfg, params, attend, tokens)
        got, _ = eng.model.decode_step(params, cache, tokens, pos_t)
        _bitwise(got, want)
        for a, b in zip(cache, want_cache):
            _bitwise(a["k"], b["k"])
            _bitwise(a["v"], b["v"])
        return
    bt = 8
    n_b = W // bt
    table = torch.from_numpy((2 + rng.permutation(B * n_b)).reshape(
        B, n_b).astype(np.int32))
    pages = {n: torch.stack([_pages_of(c[n], table, bt)[0] for c in cache])
             for n in ("k", "v")}
    want_pages = {n: t.clone() for n, t in pages.items()}

    def attend(l, lp, h):
        if fused:
            return common.decode_attention_paged(
                lp["attn"], cfg, h, {n: t[l] for n, t in want_pages.items()},
                table, pos)
        return _chain_attention(lp["attn"], cfg, h, want_pages["k"][l],
                                want_pages["v"][l], pos, table)
    want = _chain_step(cfg, params, attend, tokens)
    got, _ = eng.model.decode_step_paged(params, pages, table, tokens, pos_t)
    _bitwise(got, want)
    for n in ("k", "v"):
        _bitwise(pages[n], want_pages[n])


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU decode step never reaches a kernel wrapper, counts no launch,
    and calls each plain version as often as the card launches the
    kernel: add_norm 2L + 1 times a step, rope_qk_write L times."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA kernel wrapper was called on the CPU")
    monkeypatch.setattr(dg, "add_norm_cuda", refuse)
    monkeypatch.setattr(dg, "rope_qk_write_cuda", refuse)
    calls = {"add_norm": 0, "rope_qk_write": 0}
    for name in calls:
        plain = getattr(dg, name + "_plain")

        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(dg, name + "_plain", counted)
    eng, params = _step_engine("bloom-3b")
    L = eng.cfg.n_layers
    cache = eng.model.init_cache(4, eng.cache_len, "cpu")
    tokens = torch.ones((4, 1), dtype=torch.long)
    ops.reset_launch_counts()
    logits, _ = eng.model.decode_step(params, cache, tokens, 5)
    assert torch.isfinite(logits).all()
    counts = ops.launch_counts()
    assert counts["add_norm"] == counts["rope_qk_write"] == 0
    assert calls == {"add_norm": 2 * L + 1, "rope_qk_write": L}
    # the prefill calls neither: its norms and rope are the op chains
    eng.model.prefill(params, {"tokens": torch.ones((4, 6), dtype=torch.long)},
                      eng.cache_len)
    assert calls == {"add_norm": 2 * L + 1, "rope_qk_write": L}


# -- the prefill and training keep their op chains -------------------------


def test_prefill_and_training_keep_their_op_chains(monkeypatch):
    """``apply_norm``, ``apply_rope`` and ``qkv_proj`` build op chains:
    they run on meta tensors (a kernel route raises there: no kernel for
    device meta) and carry gradients; a prefill and a training step call
    neither decode-glue entry."""
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.add_norm(torch.empty((2, 1, 64), device="meta"), None, None,
                     "layernorm")
    xm = torch.empty((2, 5, 64), device="meta")
    assert common.apply_norm("layernorm", None, xm).shape == xm.shape
    pm = torch.zeros((2, 5), dtype=torch.int32, device="meta")
    qm = torch.empty((2, 5, 4, 16), device="meta")
    assert common.apply_rope(qm, pm, 1e4).shape == qm.shape

    def refuse(*a, **k):
        raise AssertionError("a decode-glue entry outside the decode step")
    monkeypatch.setattr(ops, "add_norm", refuse)
    monkeypatch.setattr(ops, "rope_qk_write", refuse)
    cfg = get_arch("qwen3-1.7b").scaled(n_layers=2, d_model=64, n_heads=4,
                                        n_kv_heads=2, d_ff=128, vocab=256,
                                        dtype="float32")
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    p = params["layers"][0]["attn"]
    x = torch.randn((2, 5, 64), requires_grad=True)
    positions = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    q, k, v = common.qkv_proj(p, cfg, common.apply_norm("rmsnorm", None, x),
                              positions)
    (q.sum() + k.sum() + v.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    tokens = torch.randint(1, 256, (2, 6))
    logits, _ = model.prefill(params, {"tokens": tokens}, 8)
    assert torch.isfinite(logits).all()
    params["layers"][0]["norm1"].requires_grad_(True)
    loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    loss.backward()
    assert torch.isfinite(params["layers"][0]["norm1"].grad).all()


# -- add_norm's design, checked on the CPU --------------------------------


def _block_sum_model(vals: np.ndarray, threads: int) -> np.float32:
    """csrc/decode_glue.cu's block_sum over one row's per-element terms
    (float32): thread t sums elements t, t + threads, ... in order; each
    warp sums its lanes by an xor-shuffle tree; warp 0 sums the warps'
    sums (zeros past the last warp) by the same tree."""
    D = vals.shape[0]
    per = np.zeros(threads, np.float32)
    for t in range(threads):
        s = np.float32(0)
        for i in range(t, D, threads):
            s = np.float32(s + vals[i])
        per[t] = s

    def tree(lanes):
        lanes = lanes.copy()
        o = 16
        while o:
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
            o //= 2
        return lanes[0]
    warps = np.zeros(32, np.float32)
    for w in range(threads // 32):
        warps[w] = tree(per[32 * w:32 * w + 32])
    return tree(warps)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("D", [2560, 4096, 2048])
def test_add_norm_kernel_model_is_within_one_bf16_ulp(D, kind):
    """A numpy model of the kernel's arithmetic (its sum order, 1 / D,
    rsqrt as 1 / sqrt) on bf16 rows at the served widths: x_new bitwise,
    h within one bf16 ulp of the op chain."""
    threads = dg.add_norm_threads(D)
    x = _randn((4, D), torch.bfloat16, D, shift=0.5)
    y = _randn((4, D), torch.bfloat16, D + 1, scale=3.0)
    w = _randn((D,), torch.bfloat16, D + 2, scale=0.1, shift=1.0)
    x_new, want = dg.add_norm_plain(x, y, w, kind)
    xf = (x.float() + y.float()).to(torch.bfloat16)
    _bitwise(xf, x_new)
    got = []
    for row in xf.float().numpy():
        if kind == "rmsnorm":
            ms = _block_sum_model(row * row, threads) * np.float32(1 / D)
            h = row * np.float32(1 / np.sqrt(np.float32(ms + 1e-5)))
        else:
            mu = _block_sum_model(row, threads) * np.float32(1 / D)
            d = (row - mu).astype(np.float32)
            var = _block_sum_model(d * d, threads) * np.float32(1 / D)
            h = d * np.float32(1 / np.sqrt(np.float32(var + 1e-5)))
        got.append((h * w.float().numpy()).astype(np.float32))
    got = torch.from_numpy(np.stack(got)).to(torch.bfloat16)
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().clamp(
        min=2 ** -100))) - 7)
    assert ((got.float() - want.float()).abs() <= ulp).all()


def test_add_norm_block_width_plan():
    """add_norm's block: a multiple of 32 threads from 128 to 1024, with
    each thread holding at most 16 of its row's elements (the kernel's
    largest instantiation), for every served width and the limit."""
    for D in (64, 1024, 2048, 2560, 4096, 5120, 6144, 7168, 12288, 16384):
        t = dg.add_norm_threads(D)
        assert t % 32 == 0 and 128 <= t <= 1024
        assert -(-D // t) <= dg.AN_PER
    assert dg.add_norm_threads(2560) == 640
    with pytest.raises(ValueError, match="16384"):
        dg.add_norm_threads(16385)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        dg.add_norm_cuda(x, None, None, "layernorm")
    q, k, v, ck, cv = _rope_case(2, 2, 2, 16, 8, torch.float32, 0)
    with pytest.raises(ValueError, match="CUDA"):
        dg.rope_qk_write_cuda(q, k, v, 3, dg.rope_freqs(16, 1e4), ck, cv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dg.add_norm_cuda(x.half(), None, None, "layernorm")


def test_report_gives_each_captures_kernel_nodes():
    trace.reset()
    add = trace._T.add
    add(trace.Interval("dev.prefill", 1.0, 1.2, 1))
    add(trace.Span("engine.capture", 1.2, 1.3, 1, 1, 0))
    add(trace.Count("nodes", 412, 1.3, 1))
    add(trace.Interval("dev.decode", 1.3, 1.9, 1))
    add(trace.Span("engine.generate", 1.0, 2.0, 1, 0, None))
    line = trace.report()
    assert "captures 1, ms [100.0], kernel nodes [412]" in line
    trace.reset()

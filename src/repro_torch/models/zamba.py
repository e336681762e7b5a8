"""Zamba2-style hybrid (port of ``repro.models.zamba``): a Mamba2 backbone
and one SHARED attention + FFN block (one weight set) applied after every
``attn_every`` Mamba2 layers; and, where ``cfg.hybrid.sites`` is set, the
published Zamba2 block (below, "The published layout").

Layer layout for n_layers = 81, attn_every = 6: 13 groups of [6 Mamba2
layers + the shared block], then a tail of 3 Mamba2 layers.  The shared
attention has a window of ``ATTN_WINDOW`` = 4096 (the SSM state carries
the long memory), so its slot cache holds W = min(cache_len, 4096) slots.
``lm_head`` is untied.

Params: ``embed``, ``main`` (the G * K Mamba2 layer dicts, group-major;
the JAX package stacks them (G, K, ...)), ``shared`` {"attn", "ffn",
"norm1", "norm2"}, ``tail`` (a list; the JAX package's (tail, ...)),
``final_norm``, ``lm_head``.

Cache: a list in execution order, every leaf's batch on axis 0: for each
group its K Mamba2 states {"ssm" (B, H, P, N) float32, "conv" (B, K-1,
C)}, then the group's shared-attention slot cache {"k", "v"} (B, W, nkv,
dh); then the tail's states.  ``decode_step`` updates it in place.  The
shared attention decodes through ``common.decode_attention_plain``: the
JAX package serves this family on that path, with no kernel.  The
published layout's sites (below) take its ``glue`` route: the decode-glue
kernel and ``flash_decode`` (K4) over the slot cache.

**The published layout** (``cfg.hybrid.sites`` non-empty; Zamba2-7B-
Instruct, after ``transformers``' ``modeling_zamba2.py``).  The n_layers
Mamba2 layers run in order, each ``x <- x + Mamba(RMSNorm(x + t))``,
where t is 0 except at Mamba2 layer ``sites[i]``, whose input takes site
i's output t_i.  Site i runs shared block ``b = i % HYBRID_BLOCKS`` (two
blocks, ABAB), with no residual inside it:

    h   = RMSNorm_2D(concat(x, e))          e: the token's embedding
    a   = o_proj(attention(q, k, v of h))   rope over all d_head dims,
                                            logits scaled by
                                            (d_head / 2)^-1/2
    g   = RMSNorm_D(a)
    u   = g W_gate|up + B_i(A_i g)          site i's rank-r adapter
    t_i = Linear_i(W_down(gelu_erf(u_gate) * u_up))

Params: ``embed`` (tied as the unembedding), ``mamba`` (the n_layers
Mamba2 layer dicts), ``blocks`` [{"attn": {wq, wk, wv (2D, nh dh), wo},
"ffn": {w1, w3, w2}, "norm1" (2D,), "norm2" (D,)}] (HYBRID_BLOCKS),
``sites`` [{"lora_a" (D, r), "lora_b" (r, 2 d_ff), "linear" (D, D)}],
``final_norm``.  Cache: a list in execution order, each site's slot
cache {"k", "v"} (B, W, nkv, dh) before the state of the Mamba2 layer
it feeds.  In prefill each Mamba2 mixer is a device interval
``dev.prefill.mamba`` of the tracer and each site (block, adapter and
linear) one ``dev.prefill.shared``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from repro_torch.config import HYBRID_BLOCKS, ModelConfig, hybrid_attn_width
from repro_torch.kernels import ops as kops
from repro_torch.models import common, mamba2
from repro_torch.serving import trace
from repro_torch.utils.remat import maybe_remat
from repro_torch.utils.sharding import constrain, on_mesh

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

ATTN_WINDOW = 4096


def _layout(cfg: ModelConfig):
    K = cfg.hybrid.attn_every
    G = cfg.n_layers // K
    tail = cfg.n_layers - G * K
    return G, K, tail


def published(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has the published layout (a site list)."""
    return bool(cfg.hybrid.sites)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``."""
    if published(cfg):
        return _init_published(cfg, gen)
    dt = common.torch_dtype(cfg)
    dev = gen.device
    G, K, tail = _layout(cfg)
    Vp = cfg.vocab_padded()
    p = {"main": [mamba2.init_block(cfg, gen, dt) for _ in range(G * K)]}
    if tail:
        p["tail"] = [mamba2.init_block(cfg, gen, dt) for _ in range(tail)]
    p["shared"] = {"attn": common.make_attn_params(cfg, gen, dt),
                   "ffn": common.make_ffn_params(cfg, gen, dt),
                   "norm1": common.make_norm_params(cfg, dt, dev),
                   "norm2": common.make_norm_params(cfg, dt, dev)}
    p["embed"] = common.embed_init(gen, (Vp, cfg.d_model), dt)
    p["final_norm"] = common.make_norm_params(cfg, dt, dev)
    p["lm_head"] = common.dense_init(gen, (cfg.d_model, Vp), 0, dt)
    return p


def _groups(cfg: ModelConfig, params: Params):
    """The K Mamba2 layer dicts of each of the G groups."""
    G, K, _ = _layout(cfg)
    return [params["main"][g * K:(g + 1) * K] for g in range(G)]


def _shared_fwd(cfg: ModelConfig, sp: Params, x: torch.Tensor,
                positions: torch.Tensor, on_kv=None) -> torch.Tensor:
    """The shared attention + FFN block over a whole sequence."""
    B, S, _ = x.shape
    h = common.apply_norm(cfg.norm, sp["norm1"], x)
    q, k, v = common.qkv_proj(sp["attn"], cfg, h, positions)
    att = common.chunked_causal_attention(q, k, v, ATTN_WINDOW)
    att = common.mm(common.merge_heads(att),
                    sp["attn"]["wo"])
    x = x + constrain(att, "batch", None, None)
    h = common.apply_norm(cfg.norm, sp["norm2"], x)
    x = common.seq_shard(x + common.ffn_apply(sp["ffn"], cfg, h))
    if on_kv is not None:
        on_kv(k, v)
    return x


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               on_state=None, on_kv=None) -> torch.Tensor:
    """The embedded sequence through the stack and the final norm;
    ``on_state(st)`` sees each Mamba2 layer's end state and ``on_kv(k, v)``
    each shared-attention site's k/v, in execution order.  Without
    callbacks, each group's Mamba2 layers and each shared-block site go
    through ``maybe_remat``.  The JAX package wraps each Mamba2 layer and
    each group around them (its tail is not wrapped); the port does not
    nest checkpoints (a nested non-reentrant checkpoint failed its
    recompute check under PyTorch 2.11 on the card), which recomputes the
    same values."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    wrap = maybe_remat if on_state is None and on_kv is None \
        else (lambda body: body)

    def mamba_layer(x, lp):
        h = common.apply_norm(cfg.norm, lp["norm"], x)
        out, st = mamba2.block_forward(cfg, lp, h,
                                       collect_state=on_state is not None)
        if on_state is not None:
            on_state(st)
        return common.seq_shard(x + out)

    def shared(x):
        return _shared_fwd(cfg, params["shared"], x, positions, on_kv)

    m_body, s_body = wrap(mamba_layer), wrap(shared)
    for layers in _groups(cfg, params):
        for lp in layers:
            x = m_body(x, lp)
        x = s_body(x)
    for lp in params.get("tail", []):
        x = mamba_layer(x, lp)
    return common.apply_norm(cfg.norm, params["final_norm"], x)


def _init_published(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = common.torch_dtype(cfg)
    dev = gen.device
    hy, D, F = cfg.hybrid, cfg.d_model, cfg.d_ff
    d_in, H = hybrid_attn_width(cfg), cfg.n_heads * cfg.d_head
    Hkv = cfg.n_kv_heads * cfg.d_head
    p = {"mamba": [mamba2.init_block(cfg, gen, dt)
                   for _ in range(cfg.n_layers)]}
    p["blocks"] = [{"attn": {"wq": common.dense_init(gen, (d_in, H), 0, dt),
                             "wk": common.dense_init(gen, (d_in, Hkv), 0, dt),
                             "wv": common.dense_init(gen, (d_in, Hkv), 0, dt),
                             "wo": common.dense_init(gen, (H, D), 0, dt)},
                    "ffn": common.make_ffn_params(cfg, gen, dt),
                    "norm1": torch.ones((d_in,), dtype=dt, device=dev),
                    "norm2": torch.ones((D,), dtype=dt, device=dev)}
                   for _ in range(HYBRID_BLOCKS)]
    r = hy.adapter_rank
    p["sites"] = [{"lora_a": common.dense_init(gen, (D, r), 0, dt),
                   "lora_b": common.dense_init(gen, (r, 2 * F), 0, dt),
                   "linear": common.dense_init(gen, (D, D), 0, dt)}
                  for _ in hy.sites]
    p["embed"] = common.embed_init(gen, (cfg.vocab_padded(), D), dt)
    p["final_norm"] = common.make_norm_params(cfg, dt, dev)
    return p


def _attn_scale(cfg: ModelConfig) -> float:
    """The published block's logit scale, (d_head / 2)^-1/2."""
    return (cfg.d_head / 2) ** -0.5


def _site_tail(cfg: ModelConfig, bp: Params, sp: Params,
               a: torch.Tensor) -> torch.Tensor:
    """A site's block after its attention output ``a``: the norm, the
    GeGLU with the site's adapter on its gate/up, the site's linear."""
    g = _norm(cfg, bp["norm2"], a)
    m = common.ffn_apply(bp["ffn"], cfg, g,
                         (g @ sp["lora_a"]) @ sp["lora_b"])
    return m @ sp["linear"]


def _block_input(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 e: torch.Tensor) -> torch.Tensor:
    """RMSNorm of the block's input, concat(x, e)."""
    return _norm(cfg, bp["norm1"], torch.cat([x, e], dim=-1))


def _norm(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """``cfg.norm`` of x: a decode token's (S = 1) through
    ``common.add_norm`` (one kernel on CUDA), a sequence's through
    ``common.apply_norm``."""
    if x.shape[1] == 1:
        return common.add_norm(cfg.norm, w, x)[1]
    return common.apply_norm(cfg.norm, w, x)


def _run_published(cfg: ModelConfig, params: Params, e: torch.Tensor,
                   on_state=None, on_kv=None,
                   timed: bool = False) -> torch.Tensor:
    """The embedded sequence ``e`` through the published layout and the
    final norm; ``on_state`` / ``on_kv`` as ``_run_stack``'s, in
    execution order (a site's k/v before the state of the layer it
    feeds).  ``timed``: each Mamba2 mixer and each site is a device
    interval of the tracer (prefill only)."""
    B, S, _ = e.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=e.device)[None].expand(B, S)
    wrap = maybe_remat if on_state is None and on_kv is None \
        else (lambda body: body)
    site_of = {j: i for i, j in enumerate(cfg.hybrid.sites)}
    blocks = params["blocks"]

    def interval(name):
        return trace.device(name, e.device) if timed \
            else contextlib.nullcontext()

    def site(x, i):
        bp, sp = blocks[i % len(blocks)], params["sites"][i]
        with interval("dev.prefill.shared"):
            h = _block_input(cfg, bp, x, e)
            q, k, v = common.qkv_proj(bp["attn"], cfg, h, positions)
            att = common.chunked_causal_attention(q, k, v, ATTN_WINDOW,
                                                  scale=_attn_scale(cfg))
            a = constrain(common.mm(common.merge_heads(att),
                                    bp["attn"]["wo"]), "batch", None, None)
            t = _site_tail(cfg, bp, sp, a)
        if on_kv is not None:
            on_kv(k, v)
        return t

    def mamba_layer(x, u, lp):
        h = common.apply_norm(cfg.norm, lp["norm"], u)
        with interval("dev.prefill.mamba"):
            out, st = mamba2.block_forward(cfg, lp, h,
                                           collect_state=on_state is not None)
        if on_state is not None:
            # contiguous, as the decode kernel takes them
            on_state({k: v.contiguous() for k, v in st.items()})
        return common.seq_shard(x + out)

    m_body, s_body = wrap(mamba_layer), wrap(site)
    x = e
    for j, lp in enumerate(params["mamba"]):
        u = x + s_body(x, site_of[j]) if j in site_of else x
        x = m_body(x, u, lp)
    return common.apply_norm(cfg.norm, params["final_norm"], x)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor):
    if published(cfg):
        return common.mm(x, params["embed"].T)     # tied
    return common.mm(x, params["lm_head"])


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole sequence."""
    if published(cfg):
        e = constrain(common.embed(params["embed"], batch["tokens"]),
                      "batch", None, None)
        return _logits(cfg, params, _run_published(cfg, params, e))
    x = constrain(common.embed(params["embed"], batch["tokens"]), "batch", None, None)
    return common.mm(_run_stack(cfg, params, x), params["lm_head"])


def loss_fn(cfg: ModelConfig, params: Params, batch):
    from repro_torch.models.api import cross_entropy
    logits = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab,
                         batch.get("loss_mask"))
    return loss, {"loss": loss}


def cache_capacity(cfg: ModelConfig, context_len: int) -> int:
    """Slots of each shared-attention site's cache."""
    return min(context_len, ATTN_WINDOW)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Cache:
    G, K, tail = _layout(cfg)
    dt = common.torch_dtype(cfg)
    W = cache_capacity(cfg, cache_len)
    kv = (batch, W, cfg.n_kv_heads, cfg.d_head)
    cache: Cache = []
    if published(cfg):
        for j in range(cfg.n_layers):
            if j in cfg.hybrid.sites:
                cache.append({"k": torch.zeros(kv, dtype=dt, device=device),
                              "v": torch.zeros(kv, dtype=dt, device=device)})
            cache.append(mamba2.state_specs(cfg, batch, device))
        return cache
    for _ in range(G):
        cache += [mamba2.state_specs(cfg, batch, device) for _ in range(K)]
        cache.append({"k": torch.zeros(kv, dtype=dt, device=device),
                      "v": torch.zeros(kv, dtype=dt, device=device)})
    cache += [mamba2.state_specs(cfg, batch, device) for _ in range(tail)]
    return cache


def prefill(cfg: ModelConfig, params: Params, batch, cache_len: int = 0,
            out: Cache = None):
    """The prompt through the stack: (last-token logits, cache).
    ``cache_len`` sets the attention caches' capacity (0: the input
    length; at most ``ATTN_WINDOW``); ``out``: a cache of that capacity to
    fill in place and return."""
    x = constrain(common.embed(params["embed"], batch["tokens"]), "batch", None, None)
    W = cache_capacity(cfg, cache_len or x.shape[1])
    cache: Cache = []

    def slot(i):
        return out[i] if out is not None else None

    def keep_state(st):
        dst = slot(len(cache))
        if dst is not None:
            for name in ("ssm", "conv"):
                dst[name].copy_(st[name])
            st = dst
        cache.append(st)

    def keep_kv(k, v):
        dst = slot(len(cache)) or {}
        cache.append({"k": common.prefill_slots(k, W, dst.get("k")),
                      "v": common.prefill_slots(v, W, dst.get("v"))})

    if published(cfg):
        x = _run_published(cfg, params, x, keep_state, keep_kv, timed=True)
    else:
        x = _run_stack(cfg, params, x, keep_state, keep_kv)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos):
    """One decode iteration: tokens (B, 1) at position ``pos`` (a host
    int, an int32 0-d tensor or a ``DecodePos``).  Updates ``cache`` in
    place and returns (logits (B, Vp), cache)."""
    x = constrain(common.embed(params["embed"], tokens), "batch", None, None)
    dp = kops.decode_pos(pos, x.device)
    if published(cfg):
        return _decode_published(cfg, params, cache, x, dp), cache
    sp = params["shared"]
    i = 0

    def mamba_layer(x, lp, st):
        h = common.apply_norm(cfg.norm, lp["norm"], x)
        return x + mamba2.block_decode(cfg, lp, h, st)

    for layers in _groups(cfg, params):
        for lp in layers:
            x = mamba_layer(x, lp, cache[i])
            i += 1
        h = common.apply_norm(cfg.norm, sp["norm1"], x)
        x = x + common.decode_attention_plain(
            sp["attn"], cfg, h, cache[i]["k"], cache[i]["v"], dp)
        i += 1
        h = common.apply_norm(cfg.norm, sp["norm2"], x)
        x = x + common.ffn_apply(sp["ffn"], cfg, h)
    for lp in params.get("tail", []):
        x = mamba_layer(x, lp, cache[i])
        i += 1
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return common.mm(x, params["lm_head"])[:, 0], cache


def _decode_published(cfg: ModelConfig, params: Params, cache: Cache,
                      e: torch.Tensor, dp) -> torch.Tensor:
    """``decode_step``'s body in the published layout: logits (B, Vp).
    Each residual add goes with the norm after it (``common.add_norm``:
    one kernel on CUDA), a site's rope and cache write are the decode-glue
    kernel, a site's attention reads its bf16 slot cache in place through
    ``kops.flash_decode`` (K4, at the block's scale; its plain version on
    the CPU), and each Mamba2 layer's step between its projections is
    ``kops.mamba2_decode`` on CUDA: a step launches a few kernels a layer,
    not the op chains' ~60.  Those kernels take whole tensors on one card:
    on CUDA under a mesh it raises rather than run the chains there."""
    if e.is_cuda and on_mesh(e):
        raise NotImplementedError("the published Zamba2 decode step runs "
                                  "on one card: its decode kernels take "
                                  "no mesh's shards")
    site_of = {j: i for i, j in enumerate(cfg.hybrid.sites)}
    blocks = params["blocks"]
    x, out, c = e, None, 0
    for j, lp in enumerate(params["mamba"]):
        if j in site_of:
            if out is not None:
                x, out = x + out, None
            i = site_of[j]
            bp, sp = blocks[i % len(blocks)], params["sites"][i]
            a = common.decode_attention_plain(
                bp["attn"], cfg, _block_input(cfg, bp, x, e), cache[c]["k"],
                cache[c]["v"], dp, scale=_attn_scale(cfg), glue=True)
            _, h = common.add_norm(cfg.norm, lp["norm"], x,
                                   _site_tail(cfg, bp, sp, a))
            c += 1
        else:
            x, h = common.add_norm(cfg.norm, lp["norm"], x, out)
        out = mamba2.block_decode(cfg, lp, h, cache[c], use_kernel=True)
        c += 1
    _, h = common.add_norm(cfg.norm, params["final_norm"], x, out)
    return _logits(cfg, params, h)[:, 0]


def decode_tier(cfg: ModelConfig, params: Params) -> str:
    """K4 ("flash") at the published layout's sites, else no kernel."""
    return "flash" if published(cfg) else "none"


def state_bytes(cfg: ModelConfig, cache: Cache) -> int:
    """Twice the bytes of the SSM and conv state a decode step updates."""
    return 2 * sum(leaf.nbytes for layer in cache
                   for name, leaf in layer.items() if name in ("ssm", "conv"))


def input_specs(cfg: ModelConfig, shape):
    """The step's inputs as meta tensors (the dry run's; no allocation)."""
    from repro_torch.models.api import token_specs
    return token_specs(shape)

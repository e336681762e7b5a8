"""Zamba2-style hybrid (port of ``repro.models.zamba``): a Mamba2 backbone
and one SHARED attention + FFN block (one weight set) applied after every
``attn_every`` Mamba2 layers.

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
JAX package serves this family on that path, with no kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common, mamba2
from repro_torch.utils.remat import maybe_remat
from repro_torch.utils.sharding import constrain

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

ATTN_WINDOW = 4096


def _layout(cfg: ModelConfig):
    K = cfg.hybrid.attn_every
    G = cfg.n_layers // K
    tail = cfg.n_layers - G * K
    return G, K, tail


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``."""
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


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole sequence."""
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

    x = _run_stack(cfg, params, x, keep_state, keep_kv)
    return common.mm(x[:, -1:], params["lm_head"])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos):
    """One decode iteration: tokens (B, 1) at position ``pos`` (a host
    int, an int32 0-d tensor or a ``DecodePos``).  Updates ``cache`` in
    place and returns (logits (B, Vp), cache)."""
    x = constrain(common.embed(params["embed"], tokens), "batch", None, None)
    dp = kops.decode_pos(pos, x.device)
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


def input_specs(cfg: ModelConfig, shape):
    """The step's inputs as meta tensors (the dry run's; no allocation)."""
    from repro_torch.models.api import token_specs
    return token_specs(shape)

"""Decoder-only dense transformer (port of the dense family of
``repro.models.transformer``).

Params are a dict: ``embed`` (Vp, D), ``layers`` (a list of per-layer
dicts {"attn", "ffn", "norm1", "norm2"}; the JAX package stacks them on
axis 0 and scans), ``final_norm`` and, without tied embeddings,
``lm_head``.  The decode cache is a list of per-layer {"k", "v"} slot
caches (B, W, nkv, dh), updated in place by ``decode_step``;
``decode_step_paged`` reads and writes a paged arena instead.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.quant.ptq import QTensor

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    if cfg.sliding_window or cfg.qk_norm:
        raise NotImplementedError("sliding_window / qk_norm are not "
                                  "ported yet")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``: the JAX package's
    distributions (it draws other numbers from the same seed)."""
    _check_family(cfg)
    dt = common.torch_dtype(cfg)
    dev = gen.device
    params = {"embed": common.embed_init(gen, (cfg.vocab_padded(), cfg.d_model), dt)}
    params["layers"] = [
        {"attn": common.make_attn_params(cfg, gen, dt),
         "norm1": common.make_norm_params(cfg, dt, dev),
         "norm2": common.make_norm_params(cfg, dt, dev),
         "ffn": common.make_ffn_params(cfg, gen, dt)}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = common.make_norm_params(cfg, dt, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, (cfg.d_model, cfg.vocab_padded()), 0, dt)
    return params


def _table(params: Params) -> torch.Tensor:
    """``dequant(embed)``: a quantized table is dequantized once and kept
    (``QTensor.dense``), not every step."""
    emb = params["embed"]
    return emb.dense() if isinstance(emb, QTensor) else emb


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ _table(params).T
    return common.mm(x, params["lm_head"])


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Cache:
    _check_family(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    dt = common.torch_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def _layers(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            on_kv=None) -> torch.Tensor:
    """The embedded ``tokens`` (B, S) through every layer, causal; returns
    the hidden states before the final norm.  ``on_kv(k, v)`` sees each
    layer's k/v (B, S, nkv, dh)."""
    _check_family(cfg)
    x = _table(params)[tokens]
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    for lp in params["layers"]:
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = common.qkv_proj(lp["attn"], cfg, h, positions)
        att = common.chunked_causal_attention(q, k, v)
        x = x + common.mm(att.reshape(B, S, cfg.n_heads * cfg.d_head),
                          lp["attn"]["wo"])
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + common.ffn_apply(lp["ffn"], cfg, h)
        if on_kv is not None:
            on_kv(k, v)
    return x


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole sequence (causal, no cache)."""
    x = _layers(cfg, params, batch["tokens"])
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """(mean next-token cross-entropy, {"loss", "aux_loss"}); dense models
    have no auxiliary loss."""
    from repro_torch.models.api import cross_entropy
    loss = cross_entropy(forward(cfg, params, batch), batch["labels"],
                         cfg.vocab, batch.get("loss_mask"))
    return loss, {"loss": loss, "aux_loss": torch.zeros((), device=loss.device)}


def prefill(cfg: ModelConfig, params: Params, batch, cache_len: int = 0,
            out: Cache = None):
    """Run the prompt through the stack; return (last-token logits, cache).
    ``cache_len`` sets decode cache capacity (0 => prompt length).
    ``out``: a cache of that capacity to fill in place and return (a
    decode loop's, which keeps its address)."""
    W = cache_len or batch["tokens"].shape[1]
    cache: Cache = []

    def keep(k, v):
        layer = None if out is None else out[len(cache)]
        ck, cv = common.prefill_cache_from_kv(
            k, v, W, None if layer is None else (layer["k"], layer["v"]))
        cache.append({"k": ck, "v": cv})

    x = _layers(cfg, params, batch["tokens"], keep)
    x = common.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, x)[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos, use_kernel: bool = True):
    """One decode iteration.  tokens: (B, 1) int; pos: the position of
    this token (the cache holds positions < pos), an int32 0-d tensor on
    the tokens' device (what a captured step replays) or a host int, which
    takes the same tensor code.  The slot, valid counts and rope rows
    derived from it are made once and shared by the layers.  Updates
    ``cache`` in place and returns (logits, cache).  ``use_kernel`` routes
    attention through the decode kernel; off, it takes the plain masked
    softmax, on CPU tensors only."""
    x = _table(params)[tokens]
    dp = kops.decode_pos(pos, x.device)
    for lp, layer_cache in zip(params["layers"], cache):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        x = x + common.decode_attention_cache(lp["attn"], cfg, h, layer_cache,
                                              dp, use_kernel)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + common.ffn_apply(lp["ffn"], cfg, h)
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], cache


def decode_step_paged(cfg: ModelConfig, params: Params,
                      pages: Dict[str, torch.Tensor], table: torch.Tensor,
                      tokens: torch.Tensor, pos, use_kernel: bool = True):
    """One decode iteration over the PAGED cache.  ``pages``: arena leaves
    stacked over layers, {"k", "v"} of shape (L, P, block_tokens, nkv',
    dh'); layer l works on the views ``pages[name][l]``.  ``table``: (B,
    n_b) int32 block table, shared by every layer (one page id covers all
    L layers of a row's block).  ``pos`` as for ``decode_step``.  Updates
    ``pages`` in place and returns (logits, pages)."""
    x = _table(params)[tokens]
    dp = kops.decode_pos(pos, x.device)
    for l, lp in enumerate(params["layers"]):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        x = x + common.decode_attention_paged(
            lp["attn"], cfg, h, {name: leaf[l] for name, leaf in pages.items()},
            table, dp, use_kernel)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + common.ffn_apply(lp["ffn"], cfg, h)
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], pages

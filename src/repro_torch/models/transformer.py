"""Decoder-only transformer covering the dense, MoE and VLM families (port
of ``repro.models.transformer``).

Params are a dict: ``embed`` (Vp, D), ``layers`` (a list of per-layer
dicts {"attn", "norm1", "norm2"} and "ffn", or "moe" for a MoE model; the
JAX package stacks them on axis 0 and scans), ``final_norm`` and, without
tied embeddings, ``lm_head``.  GQA with an optional sliding window and
qk-norm; the MoE FFN is top-k capacity dispatch; a VLM prepends the stub
vision frontend's patch embeddings (``batch["patch_embeds"]``) to the text
embeddings.  The decode cache is a list of per-layer {"k", "v"} slot
caches (B, W, nkv, dh), W the context or the sliding window (+ {"ks",
"vs"} (B, W, nkv) scales with kv_bits=8), updated in place by
``decode_step``; ``decode_step_paged`` reads and writes a paged arena
instead.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.quant.ptq import QTensor
from repro_torch.utils.remat import maybe_remat
from repro_torch.utils.sharding import constrain

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]
KERNEL_WEIGHTS = True     # QTensor trees on quant_matmul; steps take use_kernel


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``: the JAX package's
    distributions (it draws other numbers from the same seed)."""
    dt = common.torch_dtype(cfg)
    dev = gen.device

    def layer():
        p = {"attn": common.make_attn_params(cfg, gen, dt),
             "norm1": common.make_norm_params(cfg, dt, dev),
             "norm2": common.make_norm_params(cfg, dt, dev)}
        if cfg.is_moe:
            p["moe"] = common.make_moe_params(cfg, gen, dt)
        else:
            p["ffn"] = common.make_ffn_params(cfg, gen, dt)
        return p

    params = {"embed": common.embed_init(gen, (cfg.vocab_padded(), cfg.d_model), dt)}
    params["layers"] = [layer() for _ in range(cfg.n_layers)]
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


def cache_capacity(cfg: ModelConfig, context_len: int) -> int:
    """Slots of the decode cache: the context, or the sliding window."""
    return min(context_len, cfg.sliding_window) if cfg.sliding_window \
        else context_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Cache:
    """Zero slot caches of ``cache_capacity`` slots; with kv_bits=8, int8
    values and scales set to one, as in the JAX package."""
    W = cache_capacity(cfg, cache_len)
    shape = (batch, W, cfg.n_kv_heads, cfg.d_head)
    if cfg.kv_bits == 8:
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device),
                 "vs": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device)}
                for _ in range(cfg.n_layers)]
    dt = common.torch_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor,
         with_aux: bool = False):
    """The layer's FFN, or its MoE layer: (out, aux loss or None)."""
    if cfg.is_moe:
        return common.moe_apply(lp["moe"], cfg, h, with_aux=with_aux)
    return common.ffn_apply(lp["ffn"], cfg, h), None


def _embed_inputs(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """The token embeddings (B, S, D); a VLM prepends the stub vision
    frontend's patch embeddings (B, n_img, D), already projected to
    d_model."""
    x = common.embed(_table(params), batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return constrain(x, "batch", None, None)


def _layers(cfg: ModelConfig, params: Params, batch, on_kv=None,
            with_aux: bool = False):
    """The embedded inputs of ``batch`` through every layer, causal (within
    the sliding window, if any); returns (the hidden states before the
    final norm, the summed MoE aux loss or None).  ``on_kv(k, v)`` sees
    each layer's k/v (B, S, nkv, dh).  Without ``on_kv`` each layer goes
    through ``maybe_remat``."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    def layer(x, lp):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = common.qkv_proj(lp["attn"], cfg, h, positions)
        att = common.chunked_causal_attention(q, k, v, cfg.sliding_window)
        att = common.mm(common.merge_heads(att),
                        lp["attn"]["wo"])
        x = x + constrain(att, "batch", None, None)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        out, a = _ffn(cfg, lp, h, with_aux)
        if on_kv is not None:
            on_kv(k, v)
        return common.seq_shard(x + out), a

    body = layer if on_kv is not None else maybe_remat(layer)
    aux = None
    for lp in params["layers"]:
        x, a = body(x, lp)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole sequence (causal, no cache)."""
    x, _ = _layers(cfg, params, batch)
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """(next-token cross-entropy + 0.01 x the MoE aux loss, {"loss",
    "aux_loss"}); a dense model's aux loss is zero, and a VLM's image
    positions carry no LM loss."""
    from repro_torch.models.api import cross_entropy
    x, aux = _layers(cfg, params, batch, with_aux=True)
    logits = _unembed(cfg, params,
                      common.apply_norm(cfg.norm, params["final_norm"], x))
    if cfg.family == "vlm":
        logits = logits[:, cfg.vlm.n_img_tokens:]
    loss = cross_entropy(logits, batch["labels"], cfg.vocab,
                         batch.get("loss_mask"))
    if aux is None:
        aux = torch.zeros((), device=loss.device)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: Params, batch, cache_len: int = 0,
            out: Cache = None):
    """Run the prompt through the stack; return (last-token logits, cache).
    ``cache_len`` sets decode cache capacity (0 => the input length; a
    sliding window bounds it).  ``out``: a cache of that capacity to fill
    in place and return (a decode loop's, which keeps its address).  With
    kv_bits=8 the cache holds ``quantize_kv`` of every position's k/v and
    their scales (zero in the slots no position fills)."""
    S = batch["tokens"].shape[1]
    if cfg.family == "vlm":
        S += batch["patch_embeds"].shape[1]
    W = cache_capacity(cfg, cache_len or S)
    cache: Cache = []

    def keep(k, v):
        layer = out[len(cache)] if out is not None else {}
        if cfg.kv_bits == 8:
            (kq, ks), (vq, vs) = common.quantize_kv(k), common.quantize_kv(v)
            vals = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        else:
            vals = {"k": k, "v": v}
        cache.append({name: common.prefill_slots(val, W, layer.get(name))
                      for name, val in vals.items()})

    x, _ = _layers(cfg, params, batch, keep)
    x = common.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, x)[:, 0], cache


def _decode_layers(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   attend, use_kernel: bool) -> torch.Tensor:
    """The layers of a decode step over the embedded tokens x (B, 1, D),
    each residual add fused with the norm after it (``common.add_norm``:
    norm2, then the next layer's norm1 or the final norm);
    ``attend(l, lp, h)`` is layer l's attention on its normed input.
    Returns the final norm's output."""
    layers = params["layers"]
    norms = [lp["norm1"] for lp in layers] + [params["final_norm"]]
    x, h = common.add_norm(cfg.norm, norms[0], x, use_kernel=use_kernel)
    for l, lp in enumerate(layers):
        x, h = common.add_norm(cfg.norm, lp["norm2"], x, attend(l, lp, h),
                               use_kernel)
        x, h = common.add_norm(cfg.norm, norms[l + 1], x,
                               _ffn(cfg, lp, h)[0], use_kernel)
    return h


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos, use_kernel: bool = True):
    """One decode iteration.  tokens: (B, 1) int; pos: the position of
    this token (the cache holds positions < pos), an int32 0-d tensor on
    the tokens' device (what a captured step replays) or a host int, which
    takes the same tensor code.  The slot, valid counts and rope rows
    derived from it are made once and shared by the layers.  Updates
    ``cache`` in place and returns (logits, cache).  ``use_kernel`` routes
    attention through the decode kernel, and the residual adds, norms,
    rope and cache writes through the decode-glue kernels; off, attention
    takes the plain masked softmax and the rest the op chains, on CPU
    tensors only."""
    x = constrain(common.embed(_table(params), tokens), "batch", None, None)
    dp = kops.decode_pos(pos, x.device)
    h = _decode_layers(
        cfg, params, x, lambda l, lp, h: common.decode_attention_cache(
            lp["attn"], cfg, h, cache[l], dp, use_kernel), use_kernel)
    return _unembed(cfg, params, h)[:, 0], cache


def decode_step_paged(cfg: ModelConfig, params: Params,
                      pages: Dict[str, torch.Tensor], table: torch.Tensor,
                      tokens: torch.Tensor, pos, use_kernel: bool = True):
    """One decode iteration over the PAGED cache.  ``pages``: arena leaves
    stacked over layers, {"k", "v"} of shape (L, P, block_tokens, nkv',
    dh') (+ {"ks", "vs"} (L, P, block_tokens, nkv') with kv_bits=8);
    layer l works on the views ``pages[name][l]``.  ``table``: (B, n_b)
    int32 block table, shared by every layer (one page id covers all L
    layers of a row's block).  ``pos`` as for ``decode_step``.  Updates
    ``pages`` in place and returns (logits, pages)."""
    x = constrain(common.embed(_table(params), tokens), "batch", None, None)
    dp = kops.decode_pos(pos, x.device)
    h = _decode_layers(
        cfg, params, x, lambda l, lp, h: common.decode_attention_paged(
            lp["attn"], cfg, h, {name: leaf[l] for name, leaf in pages.items()},
            table, dp, use_kernel), use_kernel)
    return _unembed(cfg, params, h)[:, 0], pages


def decode_tier(cfg: ModelConfig, params: Params) -> str:
    """``kops.decode_kernel_tier`` of ``params``' first layer."""
    return kops.decode_kernel_tier(params["layers"][0]["attn"], cfg)


def prompt_batch(cfg: ModelConfig, tokens: torch.Tensor):
    """Prompt tokens as a batch; a VLM's adds zero stub patch embeddings."""
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.vlm.n_img_tokens, cfg.d_model),
            dtype=common.torch_dtype(cfg), device=tokens.device)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The step's inputs as meta tensors (the dry run's; no allocation):
    a VLM's text is the sequence less its image positions, whose patch
    embeddings come beside it."""
    from repro_torch.models.api import meta, token_specs
    n_img = cfg.vlm.n_img_tokens if cfg.family == "vlm" else 0
    if shape.kind == "decode":
        return token_specs(shape)
    batch = token_specs(shape, shape.seq_len - n_img)
    if n_img:
        batch["patch_embeds"] = meta(
            (shape.global_batch, n_img, cfg.d_model), common.torch_dtype(cfg))
    return batch

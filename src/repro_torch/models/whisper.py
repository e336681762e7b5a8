"""Whisper-style encoder-decoder transformer, the audio family (port of
``repro.models.whisper``).

The mel-spectrogram and conv1d feature extractor is a stub, as in the JAX
package: ``batch["audio_embeds"]`` (B, n_frames, d_model) arrive
precomputed.  The encoder is a bidirectional transformer over the frames;
the decoder is causal, with cross-attention to the encoder output, and
unembeds through the tied table (``x @ embed.T``).

Params: ``embed``, ``enc_layers`` / ``dec_layers`` (lists of per-layer
dicts; the JAX package stacks them (L, ...)), ``enc_norm``,
``final_norm``.  Cache: one dict a decoder layer, batch on axis 0 of every
leaf: the self-attention slot cache {"k", "v"} (B, W, nkv, dh) and the
cross-attention keys and values {"xk", "xv"} (B, F, nkv, dh), computed
once at prefill.  Decode self-attention is ``common.decode_attention_plain``
(the JAX package's path for this family: no kernel).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.utils.remat import maybe_remat
from repro_torch.utils.sharding import constrain

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``."""
    dt = common.torch_dtype(cfg)
    dev = gen.device

    def enc_layer():
        return {"attn": common.make_attn_params(cfg, gen, dt),
                "ffn": common.make_ffn_params(cfg, gen, dt),
                "norm1": common.make_norm_params(cfg, dt, dev),
                "norm2": common.make_norm_params(cfg, dt, dev)}

    def dec_layer():
        return {"attn": common.make_attn_params(cfg, gen, dt),
                "xattn": common.make_attn_params(cfg, gen, dt),
                "ffn": common.make_ffn_params(cfg, gen, dt),
                "norm1": common.make_norm_params(cfg, dt, dev),
                "norm2": common.make_norm_params(cfg, dt, dev),
                "norm3": common.make_norm_params(cfg, dt, dev)}

    return {
        "embed": common.embed_init(gen, (cfg.vocab_padded(), cfg.d_model), dt),
        "enc_layers": [enc_layer() for _ in range(cfg.encdec.n_enc_layers)],
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "enc_norm": common.make_norm_params(cfg, dt, dev),
        "final_norm": common.make_norm_params(cfg, dt, dev),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(cfg: ModelConfig, params: Params,
           audio_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over the frame embeddings (B, F, D): bidirectional
    attention over every frame; returns (B, F, D).  Each layer goes
    through ``maybe_remat``."""
    x = constrain(audio_embeds.to(common.torch_dtype(cfg)), "batch", None,
                  None)
    B, F_, _ = x.shape
    positions = _positions(B, F_, x.device)

    def layer(x, lp):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        x = x + common.attention_block(lp["attn"], cfg, h, positions,
                                       bidirectional=True)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        return x + common.ffn_apply(lp["ffn"], cfg, h)

    body = maybe_remat(layer)
    for lp in params["enc_layers"]:
        x = body(x, lp)
    return common.apply_norm(cfg.norm, params["enc_norm"], x)


def _unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"].T


def _decoder(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
             enc: torch.Tensor, on_layer=None) -> torch.Tensor:
    """Teacher-forced decoder pass; returns the final-normed hidden states.
    ``on_layer(k, v, xk, xv)`` sees each layer's self-attention k/v (B, S,
    nkv, dh) and cross-attention keys and values; without it each layer
    goes through ``maybe_remat``."""
    x = constrain(common.embed(params["embed"], tokens), "batch", None, None)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)

    def layer(x, lp):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = common.qkv_proj(lp["attn"], cfg, h, positions)
        att = common.chunked_causal_attention(q, k, v)
        att = common.mm(common.merge_heads(att),
                        lp["attn"]["wo"])
        x = x + constrain(att, "batch", None, None)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        xk, xv = common.cross_kv(lp["xattn"], cfg, enc)
        x = x + common.cross_attend(lp["xattn"], cfg, h, xk, xv)
        h = common.apply_norm(cfg.norm, lp["norm3"], x)
        if on_layer is not None:
            on_layer(k, v, xk, xv)
        return common.seq_shard(x + common.ffn_apply(lp["ffn"], cfg, h))

    body = layer if on_layer is not None else maybe_remat(layer)
    for lp in params["dec_layers"]:
        x = body(x, lp)
    return common.apply_norm(cfg.norm, params["final_norm"], x)


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole decoder sequence."""
    enc = encode(cfg, params, batch["audio_embeds"])
    return _unembed(params, _decoder(cfg, params, batch["tokens"], enc))


def loss_fn(cfg: ModelConfig, params: Params, batch):
    from repro_torch.models.api import cross_entropy
    logits = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab,
                         batch.get("loss_mask"))
    return loss, {"loss": loss}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Cache:
    dt = common.torch_dtype(cfg)
    kv = (batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    xkv = (batch, cfg.encdec.n_audio_frames, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(kv, dtype=dt, device=device),
             "v": torch.zeros(kv, dtype=dt, device=device),
             "xk": torch.zeros(xkv, dtype=dt, device=device),
             "xv": torch.zeros(xkv, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params: Params, batch, cache_len: int = 0,
            out: Cache = None):
    """Encode the audio, run the prompt through the decoder: (last-token
    logits, cache).  ``cache_len`` sets the self-attention caches' slots
    (0: the prompt length); ``out``: a cache of that capacity to fill in
    place and return."""
    enc = encode(cfg, params, batch["audio_embeds"])
    W = cache_len or batch["tokens"].shape[1]
    cache: Cache = []

    def keep(k, v, xk, xv):
        dst = out[len(cache)] if out is not None else {}
        layer = {"k": common.prefill_slots(k, W, dst.get("k")),
                 "v": common.prefill_slots(v, W, dst.get("v"))}
        for name, val in (("xk", xk), ("xv", xv)):
            layer[name] = dst[name].copy_(val) if name in dst else val
        cache.append(layer)

    x = _decoder(cfg, params, batch["tokens"], enc, keep)
    return _unembed(params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos):
    """One decode iteration at position ``pos`` (a host int, an int32 0-d
    tensor or a ``DecodePos``): the self-attention caches are updated in
    place; the cross-attention keys and values are read only.  Returns
    (logits (B, Vp), cache)."""
    x = constrain(common.embed(params["embed"], tokens), "batch", None, None)
    dp = kops.decode_pos(pos, x.device)
    for lp, c in zip(params["dec_layers"], cache):
        h = common.apply_norm(cfg.norm, lp["norm1"], x)
        x = x + common.decode_attention_plain(lp["attn"], cfg, h, c["k"],
                                              c["v"], dp)
        h = common.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + common.cross_attend(lp["xattn"], cfg, h, c["xk"], c["xv"])
        h = common.apply_norm(cfg.norm, lp["norm3"], x)
        x = x + common.ffn_apply(lp["ffn"], cfg, h)
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x)[:, 0], cache


def prompt_batch(cfg: ModelConfig, tokens: torch.Tensor):
    """Prompt tokens and the stub frontend's zero audio frame embeddings."""
    return {"tokens": tokens, "audio_embeds": torch.zeros(
        (tokens.shape[0], cfg.encdec.n_audio_frames, cfg.d_model),
        dtype=common.torch_dtype(cfg), device=tokens.device)}


def input_specs(cfg: ModelConfig, shape):
    """The step's inputs as meta tensors (the dry run's; no allocation):
    train and prefill take the encoder's (B, F, D) audio embeddings
    beside the tokens."""
    from repro_torch.models.api import meta, token_specs
    batch = token_specs(shape)
    if shape.kind != "decode":
        batch = {"audio_embeds": meta(
            (shape.global_batch, cfg.encdec.n_audio_frames, cfg.d_model),
            common.torch_dtype(cfg)), **batch}
    return batch

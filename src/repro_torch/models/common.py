"""Shared building blocks of the model families (port of
``repro.models.common``): norms, qk-norm, rotary embeddings, GQA attention
(prefill, causal, sliding-window or bidirectional, cross-attention, and
decode over a slot cache or a paged arena, float or int8 KV), FFN and the
top-k capacity-dispatch MoE layer.

Functions take params explicitly, as in the JAX package, with tensors in
the JAX package's layouts.  Prefill attention is plain matmul/softmax (it
is plain XLA in the JAX package); decode attention over a float cache goes
through ``kernels.ops.flash_decode`` / ``flash_decode_paged``, or, for int8
projections, the fused ``flash_decode_fused`` / ``flash_decode_fused_paged``
(``use_kernel``, the default; switching it off is for CPU tensors only).
Over an int8 KV cache (``kv_bits=8``) decode attention dequantizes the
cache and takes the plain masked softmax on every device, as the JAX
package does (its ``"kv8"`` tier has no kernel).  Off a mesh, a decode
step's residual adds with the norms after them (``add_norm``) and the
unfused tier's rope with the token's cache write go through the decode-glue
kernels (``kops.add_norm``, ``kops.rope_qk_write``); the prefill and
training keep the op chains of ``apply_norm`` and ``apply_rope``.  The MoE
experts' einsums run on the dequantized expert weights, outside any
kernel, as in the JAX package; the router goes through ``mm``.  Cache
writes update the cache tensors in place (the JAX package returns new
arrays): a decode step then costs no cache copy.  The recurrent, hybrid
and audio families take ``decode_attention_plain`` on every device: the
path the JAX package serves them on, with no kernel; but the published
Zamba2 block's sites (32 heads of 224 in Zamba2-7B-Instruct: the unfused
tier) take its ``glue`` route, ``flash_decode`` (K4) over their bf16 slot
caches at the block's own logit scale.

Sharding is expressed through logical-axis constraints (``constrain``,
``seq_shard``) at the JAX package's places; they return their input, with
no op dispatched, outside a launcher-installed axis context (see
utils/sharding.py).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.quant.ptq import QTensor, dequantize
from repro_torch.utils.sharding import (axis_divisor, constrain, head_local,
                                        on_mesh, seq_gather, sharded_dim)

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that dispatches quantized weights to the quantized-matmul
    tiers (QTensor leaves appear after ``quantize_tree``)."""
    return kops.qmatmul(x, w)


def maybe_dequant(w):
    """Dense-ify a possibly-quantized weight."""
    if isinstance(w, QTensor):
        return dequantize(w)
    return w


# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions, drawn from a Generator)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


def make_norm_params(cfg: ModelConfig, dtype, device) -> Optional[torch.Tensor]:
    if cfg.norm == "nonparam_ln":
        return None
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def make_attn_params(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    dm, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, (dm, cfg.n_heads * dh), 0, dtype),
        "wk": dense_init(gen, (dm, cfg.n_kv_heads * dh), 0, dtype),
        "wv": dense_init(gen, (dm, cfg.n_kv_heads * dh), 0, dtype),
        "wo": dense_init(gen, (cfg.n_heads * dh, dm), 0, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
    return p


def make_ffn_params(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    dm, df = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (dm, df), 0, dtype)}
    if cfg.act in ("silu", "geglu"):   # gated (SwiGLU, GeGLU)
        p["w3"] = dense_init(gen, (dm, df), 0, dtype)
    p["w2"] = dense_init(gen, (df, dm), 0, dtype)
    return p


def make_moe_params(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """The router (D, E) and the experts' stacked FFN weights (E, D, F) /
    (E, F, D), fan-in over axis 1 as in the JAX package."""
    E, dm, df = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": dense_init(gen, (dm, E), 0, dtype),
         "w1": dense_init(gen, (E, dm, df), 1, dtype),
         "w2": dense_init(gen, (E, df, dm), 1, dtype)}
    if cfg.act == "silu":
        p["w3"] = dense_init(gen, (E, dm, df), 1, dtype)
    return p


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def apply_norm(kind: str, w: Optional[torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:  # layernorm / nonparam_ln
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return seq_gather(y.to(x.dtype))


def add_norm(kind: str, w: Optional[torch.Tensor], x: torch.Tensor,
             y: Optional[torch.Tensor] = None,
             use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode step's residual add and the norm after it: (x + y,
    ``apply_norm(kind, w, x + y)``), or (x, ``apply_norm(kind, w, x)``)
    with ``y`` None.  With ``use_kernel`` and off a mesh, ``kops.add_norm``
    (one kernel on CUDA); otherwise the op chain."""
    if use_kernel and not on_mesh(x):
        return kops.add_norm(x, y, w, kind)
    if y is not None:
        x = x + y
    return x, apply_norm(kind, w, x)


def rms_head_norm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over the head dim (Qwen3's qk-norm)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Split
    halves: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def split_heads(y: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n * dh) -> (B, S, n, dh).  Under a mesh a sharded last dim
    first gathers unless ``n`` divides the model axis (a shard may not
    split a head: DTensor cannot view it so); without one, the reshape."""
    B, S = y.shape[:2]
    if on_mesh(y) and n % axis_divisor("model"):
        y = constrain(y, "batch", None, None)
    return y.reshape(B, S, n, dh)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (``table[tokens]``); under a
    mesh through ``F.embedding``, whose sharded backward DTensor runs on
    every version the port meets (its indexed-put backward of
    ``table[tokens]`` fails on a vocab- and width-sharded table under
    PyTorch 2.11)."""
    if on_mesh(table):
        return F.embedding(tokens, table)
    return table[tokens]


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(B, S, n, dh) -> (B, S, n * dh), ``split_heads``' inverse.  Under a
    mesh where ``n`` does not divide the model axis the merge runs on each
    device's shard with the heads whole, so that no gradient reaches it
    sharded across a head (DTensor cannot view one so); without one, the
    reshape."""
    B, S, n, dh = y.shape
    if not on_mesh(y) or n % axis_divisor("model") == 0:
        return y.reshape(B, S, n * dh)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim >= 2 else p
          for p in y.placements]
    y = y.redistribute(y.device_mesh, pl)
    loc = y.to_local()
    return DTensor.from_local(loc.reshape(loc.shape[0], loc.shape[1], n * dh),
                              y.device_mesh, pl, run_check=False,
                              shape=(B, S, n * dh),
                              stride=(S * n * dh, n * dh, 1))


def qkv_proj(p: Params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, use_rope: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,nh,dh), k/v (B,S,nkv,dh)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    q = split_heads(mm(x, p["wq"]), cfg.n_heads, dh)
    k = split_heads(mm(x, p["wk"]), cfg.n_kv_heads, dh)
    v = split_heads(mm(x, p["wv"]), cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, None)
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, nh, dh); k, v: (B, Sk, nkv, dh); mask broadcastable to
    (B, nkv, G, Sq, Sk) with True = attend; ``scale`` the logits' factor
    (None: 1/sqrt(dh)).  Returns (B, Sq, nh, dh).
    Under a mesh it runs on each device's batch and head shard
    (``head_local``; heads sharded when the KV heads divide the model
    axis), or, over a slot-sharded decode cache, on the sharded slots with
    q's heads replicated."""
    d = axis_divisor("model")
    if d > 1 and sharded_dim(k, "model") == 1:
        return _gqa_attention(constrain(q, "batch", None, None, None), k, v,
                              mask, scale)
    return head_local(functools.partial(_gqa_attention, scale=scale),
                      (q, k, v, mask), (2, 2, 2, None), k.shape[2] % d == 0)


def _gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor],
                   scale: Optional[float] = None) -> torch.Tensor:
    """``gqa_attention``'s math.  Logits and the weighted sum accumulate in
    float32; the probabilities are rounded to v's type first, as in the
    JAX package."""
    B, Sq, nh, dh = q.shape
    nkv = k.shape[2]
    G = nh // nkv
    qg = q.reshape(B, Sq, nkv, G, dh).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) \
        * (1.0 / math.sqrt(dh) if scale is None else scale)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(B, Sq, nh, dh).to(q.dtype)


def causal_mask(Sq: int, Sk: int, window: int = 0, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) boolean mask; window > 0 adds a sliding-window lower
    bound; q_offset shifts query positions."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None, None]


def seq_shard(x: torch.Tensor) -> torch.Tensor:
    """Sequence-shard a (B, S, D) residual over the model axis (Megatron
    sequence parallelism): the layer carry is what backward saves per
    layer.  No-op when S is not divisible or no mesh context is
    installed."""
    return constrain(x, "batch", "model", None)


def _attn_logits_shard(logits: torch.Tensor) -> torch.Tensor:
    """Shard (B, H, Q, Sk) attention logits: prefer heads on 'model',
    fall back to the key dim (sequence-parallel softmax) when the head
    count doesn't divide (e.g. 56 heads on a 16-way axis)."""
    d = axis_divisor("model")
    if d <= 1:
        return logits
    H, Sk = logits.shape[1], logits.shape[3]
    if H % d == 0:
        return constrain(logits, "batch", "model", None, None)
    if Sk % d == 0:
        return constrain(logits, "batch", None, None, "model")
    return constrain(logits, "batch", None, None, None)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int = 0,
                             chunk: int = 512,
                             q_offset: int = 0,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Blocked causal attention: a loop over query chunks, so the S x S
    score matrix never materializes; the direct masked form for short
    sequences.  q: (B,S,nh,dh), k/v: (B,Sk,nkv,dh); ``scale`` the logits'
    factor (None: 1/sqrt(dh))."""
    B, S, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    if S <= chunk or S % chunk:
        return gqa_attention(q, k, v, causal_mask(S, Sk, window, q_offset,
                                                  q.device), scale)
    k_r = (k.repeat_interleave(G, dim=2) if G > 1 else k).to(torch.float32)
    v_r = (v.repeat_interleave(G, dim=2) if G > 1 else v).to(torch.float32)
    k_r = constrain(k_r, "batch", None, "model", None)
    v_r = constrain(v_r, "batch", None, "model", None)
    return head_local(functools.partial(_chunked_attention, window=window,
                                        chunk=chunk, q_offset=q_offset,
                                        scale=scale),
                      (q, k_r, v_r), (2, 2, 2), nh % axis_divisor("model") == 0)


def _chunked_attention(q: torch.Tensor, k_r: torch.Tensor, v_r: torch.Tensor,
                       window: int, chunk: int, q_offset: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``chunked_causal_attention``'s loop over query chunks; k_r, v_r
    (B, Sk, nh, dh) float32, repeated to q's heads."""
    B, S, nh, dh = q.shape
    Sk = k_r.shape[1]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for i in range(S // chunk):
        qb = q[:, i * chunk:(i + 1) * chunk].to(torch.float32)
        logits = _attn_logits_shard(
            torch.einsum("bqhd,bshd->bhqs", qb, k_r)
            * (1.0 / math.sqrt(dh) if scale is None else scale))
        qpos = (i * chunk + q_offset) + torch.arange(chunk, device=q.device)[:, None]
        m = kpos <= qpos
        if window > 0:
            m &= kpos > qpos - window
        logits = logits.masked_fill(~m[None, None], -1e30)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs, v_r).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int = 0,
                    bidirectional: bool = False,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence self-attention with its output projection (no
    residual add): causal (within ``window``, if any) or, for Whisper's
    encoder, bidirectional over every position.  x: (B, S, D) -> (B, S,
    D)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, cfg, x, positions, use_rope)
    if bidirectional:
        out = gqa_attention(q, k, v, None)
    else:
        out = chunked_causal_attention(q, k, v, window)
    out = mm(merge_heads(out), p["wo"])
    return constrain(out, "batch", None, None)


def cross_kv(p: Params, cfg: ModelConfig, enc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values (B, F, nkv, dh) of encoder states
    enc (B, F, D), no rope (Whisper's decoder computes them once, at
    prefill)."""
    k = split_heads(mm(enc, p["wk"]), cfg.n_kv_heads, cfg.d_head)
    v = split_heads(mm(enc, p["wv"]), cfg.n_kv_heads, cfg.d_head)
    return k, v


def cross_attend(p: Params, cfg: ModelConfig, h: torch.Tensor,
                 xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Queries h (B, S, D) over every encoder position's ``cross_kv``
    (unmasked), through the output projection: (B, S, D)."""
    B, S, _ = h.shape
    q = split_heads(mm(h, p["wq"]), cfg.n_heads, cfg.d_head)
    out = gqa_attention(q, xk, xv, None)
    out = mm(merge_heads(out), p["wo"])
    return constrain(out, "batch", None, None)


# ---------------------------------------------------------------------------
# Decode attention over a slot cache
# ---------------------------------------------------------------------------
# Cache layout per layer: k/v (B, W, nkv, dh), W = cache capacity (the
# context, or the sliding window).  Position p writes slot p % W; rope is
# applied before caching, so a validity count suffices for masking.  With
# kv_bits=8 the k/v leaves are int8 and "ks"/"vs" (B, W, nkv) hold one
# float32 scale per (slot, KV head).


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, nkv, dh) -> int8 values + per-(B, S, nkv) float32 scales.
    The scale is ``absmax / 127.0``, a divide, as in the JAX package (the
    activations' ``quantize_rowwise`` multiplies by float32(1/127)
    instead)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def cache_write(pairs, pos) -> None:
    """Write each (cache leaf (B, W, ...), one token's value (B, 1, ...))
    pair at slot pos % W, in place (``index_copy_`` at a device index: pos
    is an int, a 0-d tensor or a ``DecodePos``)."""
    W = pairs[0][0].shape[1]
    slot = kops.cache_slot(kops.decode_pos(pos, pairs[0][1].device), W)
    for leaf, val in pairs:
        if sharded_dim(leaf, "model") == 1:
            # a slot-sharded cache (launch/steps.cache_specs): a one-hot
            # elementwise write, as in the JAX package, which each device
            # does on its own slots (an indexed write would gather them)
            hit = (torch.arange(W, device=val.device) == slot)
            hit = hit.reshape((1, W) + (1,) * (leaf.ndim - 2))
            leaf.copy_(torch.where(hit, val.to(leaf.dtype), leaf))
        else:
            leaf.index_copy_(1, slot, val.to(leaf.dtype))


def _decode_qkv_write(p: Params, cfg: ModelConfig, x: torch.Tensor, dp,
                      k_dst: torch.Tensor, v_dst: torch.Tensor,
                      table: Optional[torch.Tensor] = None,
                      use_rope: bool = True) -> torch.Tensor:
    """One decode token's projections (qk-norm included), rope on q and k,
    and k and v written into the cache: a slab (B, W, nkv, dh) at slot
    pos % W, or, with ``table``, the page views at page ``table[b, pos //
    bt]``, offset ``pos % bt``.  Returns q (B, 1, nh, dh).  Off a mesh the
    rope and the write are ``kops.rope_qk_write`` (one kernel on CUDA);
    on a mesh, ``qkv_proj``'s rope and ``cache_write`` / ``index_put_``."""
    B = x.shape[0]
    if on_mesh(x):
        q, k1, v1 = qkv_proj(p, cfg, x, kops.rope_positions(dp, B), use_rope)
        if table is None:
            cache_write(((k_dst, k1), (v_dst, v1)), dp)
        else:
            index = kops.page_index(dp, table, k_dst.shape[1], B)
            k_dst.index_put_(index, k1[:, 0].to(k_dst.dtype))
            v_dst.index_put_(index, v1[:, 0].to(v_dst.dtype))
        return q
    q, k1, v1 = qkv_proj(p, cfg, x, None, use_rope=False)
    return kops.rope_qk_write(q, k1, v1, dp, cfg.rope_theta, k_dst, v_dst,
                              table, use_rope)


def _valid_mask(n_valid: torch.Tensor, W: int) -> torch.Tensor:
    """(B, 1, 1, 1, W) mask of the slots below each row's n_valid, in the
    layout ``gqa_attention`` broadcasts."""
    slots = torch.arange(W, device=n_valid.device)
    return (slots[None, :] < n_valid[:, None])[:, None, None, None, :]


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                     use_rope: bool = True, use_kernel: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode step of the transformer family and of the
    published Zamba2 block's sites.  x: (B, 1, D);
    pos: the current position, a host int, an int32 0-d tensor on x's
    device or a ``kops.DecodePos`` (all three take the same tensor code, so
    they give the same bits).  Writes the token into the cache in place;
    returns the attention output (B, 1, D).  With ``use_kernel``, int8
    projections that ``kops.fusable_decode`` admits take the fused tier
    (``flash_decode_fused``), others ``flash_decode``, its logits scaled
    by ``scale`` (None: 1/sqrt(d_head); the fused tier takes no other).
    ``use_kernel=False`` takes ``decode_attention_plain``, which serves
    this family on CPU tensors only: on a CUDA tensor its decode attention
    is a kernel."""
    if not use_kernel:
        if x.is_cuda:
            raise ValueError("use_kernel=False: the plain decode attention "
                             "runs on the CPU only; CUDA tensors go through "
                             "the flash_decode kernel")
        return decode_attention_plain(p, cfg, x, cache_k, cache_v, pos,
                                      use_rope, scale)
    B = x.shape[0]
    dp = kops.decode_pos(pos, x.device)
    if kops.fusable_decode(p, cfg):
        # fused tier (K6): projections, rope, attention over the pre-write
        # cache plus the current token, and wo in one call; then the write
        o, k1, v1 = kops.flash_decode_fused(
            x[:, 0], p["wq"], p["wk"], p["wv"], p["wo"], cache_k, cache_v,
            dp, rope_theta=cfg.rope_theta, use_rope=use_rope)
        cache_write(((cache_k, k1[:, None]), (cache_v, v1[:, None])), dp)
        return constrain(o[:, None], "batch", None, None)
    q = _decode_qkv_write(p, cfg, x, dp, cache_k, cache_v, use_rope=use_rope)
    W = cache_k.shape[1]
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    out = kops.flash_decode(q[:, 0], cache_k, cache_v, n_valid,
                            scale)[:, None]
    out = mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])
    return constrain(out, "batch", None, None)


def decode_attention_plain(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           pos, use_rope: bool = True,
                           scale: Optional[float] = None,
                           glue: bool = False) -> torch.Tensor:
    """One-token decode attention with no attention kernel, on every
    device: the projections, rope, the write at slot pos % W and the
    masked softmax over the slots below min(pos + 1, W), its logits scaled
    by ``scale`` (None: 1/sqrt(d_head)).  It is the path the JAX package
    serves the recurrent, hybrid and audio families on (Zamba2's shared
    attention, Whisper's self-attention: its engine refuses ``use_kernel``
    for them); the transformer family reaches it only on CPU tensors,
    through ``decode_attention(use_kernel=False)``.  ``glue``: the decode
    kernels' route instead, ``decode_attention`` (off a mesh rope and the
    write on the decode-glue kernel, then ``flash_decode`` over the slot
    cache in place, at ``scale``): the published Zamba2 block's sites,
    whose unfused layout the JAX package has no kernel for."""
    if glue:
        return decode_attention(p, cfg, x, cache_k, cache_v, pos, use_rope,
                                scale=scale)
    B = x.shape[0]
    dp = kops.decode_pos(pos, x.device)
    q, k1, v1 = qkv_proj(p, cfg, x, kops.rope_positions(dp, B), use_rope)
    cache_write(((cache_k, k1), (cache_v, v1)), dp)
    W = cache_k.shape[1]
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    out = gqa_attention(q, cache_k, cache_v, _valid_mask(n_valid, W), scale)
    out = mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])
    return constrain(out, "batch", None, None)


def decode_attention_cache(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor], pos,
                           use_kernel: bool = True) -> torch.Tensor:
    """Dict-cache decode step, updated in place: {"k", "v"} float cache
    through ``decode_attention``, or, with kv_bits=8, the int8 cache plus
    its {"ks", "vs"} scales: the token's k/v are quantized and written at
    slot pos % W, the whole cache is dequantized and attention is the plain
    masked softmax on every device (the JAX package's ``"kv8"`` tier, which
    has no kernel; ``use_kernel`` does not apply)."""
    if cfg.kv_bits != 8:
        return decode_attention(p, cfg, x, cache["k"], cache["v"], pos,
                                use_kernel=use_kernel)
    B = x.shape[0]
    dp = kops.decode_pos(pos, x.device)
    q, k1, v1 = qkv_proj(p, cfg, x, kops.rope_positions(dp, B))
    k1q, k1s = quantize_kv(k1)
    v1q, v1s = quantize_kv(v1)
    cache_write(((cache["k"], k1q), (cache["v"], v1q), (cache["ks"], k1s),
                 (cache["vs"], v1s)), dp)
    W = cache["k"].shape[1]
    kd = dequantize_kv(cache["k"], cache["ks"], x.dtype)
    vd = dequantize_kv(cache["v"], cache["vs"], x.dtype)
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    out = gqa_attention(q, kd, vd, _valid_mask(n_valid, W))
    out = mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])
    return constrain(out, "batch", None, None)


def decode_attention_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           pages: Dict[str, torch.Tensor],
                           table: torch.Tensor, pos,
                           use_kernel: bool = True) -> torch.Tensor:
    """One-token decode step over a PAGED cache.

    pages: one layer's view of the node-wide arena, {"k", "v"} of shape
    (P, block_tokens, nkv', dh') (+ {"ks", "vs"} (P, block_tokens, nkv')
    scales when kv_bits == 8); table: (B, n_b) int32 on x's device,
    mapping logical block j of row b to its physical page; pos as for
    ``decode_attention``.  Page tails may be wider than this model's (nkv,
    dh) (the node's pool provisions the max over hosted cohorts), so the
    write targets and the read takes the leading (nkv, dh) corner, a
    strided view read in place.  The token is written in place
    (``index_put_`` at device indices) at page ``table[b, pos // bt]``,
    offset ``pos % bt``; dead rows' tables point at the trash page, several
    rows at once, and which of their duplicate writes lands is unspecified
    on CUDA: no live row reads that page.  Attention reads the row's
    logical blocks through ``flash_decode_paged``, or, for int8 projections
    that ``kops.fusable_decode`` admits, the fused
    ``flash_decode_fused_paged`` over the pre-write pages, which writes the
    token after; ``use_kernel=False`` gathers them into the contiguous (B,
    n_b * bt, nkv, dh) view and takes the plain masked softmax (CPU tensors
    only).  With kv_bits=8 the token's quantized k/v and scales are written
    at ``[page, off, :nkv]`` and attention dequantizes the gathered view and
    takes the plain masked softmax on every device, as the JAX package's
    paged ``"kv8"`` branch does."""
    if cfg.kv_bits == 8:
        return _decode_attention_paged_kv8(p, cfg, x, pages, table, pos)
    if not use_kernel and x.is_cuda:
        raise ValueError("use_kernel=False: the plain decode attention "
                         "runs on the CPU only; CUDA tensors go through "
                         "the flash_decode_paged kernel")
    B = x.shape[0]
    nkv, dh = cfg.n_kv_heads, cfg.d_head
    pk, pv = pages["k"], pages["v"]
    bt = pk.shape[1]
    n_b = table.shape[1]
    W = n_b * bt
    dp = kops.decode_pos(pos, x.device)
    kc, vc = pk[..., :nkv, :dh], pv[..., :nkv, :dh]
    if use_kernel and kops.fusable_decode(p, cfg):
        # fused tier (K7) over the pre-write pages, then the write
        page, off = kops.page_index(dp, table, bt, B)
        o, k1, v1 = kops.flash_decode_fused_paged(
            x[:, 0], p["wq"], p["wk"], p["wv"], p["wo"], kc, vc, table, dp,
            rope_theta=cfg.rope_theta)
        kc.index_put_((page, off), k1.to(pk.dtype))
        vc.index_put_((page, off), v1.to(pv.dtype))
        return constrain(o[:, None], "batch", None, None)
    q = _decode_qkv_write(p, cfg, x, dp, kc, vc, table)
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    if use_kernel:
        out = kops.flash_decode_paged(q[:, 0], kc, vc, table, n_valid)[:, None]
    else:
        idx = table.long()
        kd = kc[idx].reshape(B, W, nkv, dh)
        vd = vc[idx].reshape(B, W, nkv, dh)
        out = gqa_attention(q, kd, vd, _valid_mask(n_valid, W))
    out = mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])
    return constrain(out, "batch", None, None)


def _decode_attention_paged_kv8(p: Params, cfg: ModelConfig,
                                x: torch.Tensor,
                                pages: Dict[str, torch.Tensor],
                                table: torch.Tensor, pos) -> torch.Tensor:
    """``decode_attention_paged`` over int8 pages and their scale pages."""
    B = x.shape[0]
    nkv, dh = cfg.n_kv_heads, cfg.d_head
    bt = pages["k"].shape[1]
    W = table.shape[1] * bt
    dp = kops.decode_pos(pos, x.device)
    page, off = kops.page_index(dp, table, bt, B)
    q, k1, v1 = qkv_proj(p, cfg, x, kops.rope_positions(dp, B))
    idx = table.long()
    views = {}
    for name, val in zip(("k", "v"), (k1, v1)):
        vq, vs = quantize_kv(val)
        body = pages[name][..., :nkv, :dh]
        scale = pages[name + "s"][..., :nkv]
        body.index_put_((page, off), vq[:, 0])
        scale.index_put_((page, off), vs[:, 0])
        views[name] = dequantize_kv(body[idx].reshape(B, W, nkv, dh),
                                    scale[idx].reshape(B, W, nkv), x.dtype)
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    out = gqa_attention(q, views["k"], views["v"], _valid_mask(n_valid, W))
    out = mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])
    return constrain(out, "batch", None, None)


def prefill_slots(x: torch.Tensor, W: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cache leaf of W slots from prefill values x (B, S, ...):
    position p lands at slot p % W; only the last W positions survive, the
    other slots are zero.  ``out``: a (B, W, ...) leaf to fill in place
    (zeroed first), for a decode loop whose cache keeps its address."""
    B, S = x.shape[:2]
    start = max(0, S - W)
    if out is None:
        # out of place (a sharded x then gives a sharded leaf): slot j
        # holds position start + (j - start) % W, zeros past S
        if S >= W:
            out = x[:, start + (torch.arange(W, device=x.device) - start) % W]
        else:
            out = torch.cat([x, x.new_zeros((B, W - S) + tuple(x.shape[2:]))],
                            dim=1)
    else:
        out.zero_()
        out[:, torch.arange(start, S, device=x.device) % W] = x[:, start:]
    # slot caches shard over batch + slots (see launch/steps.cache_specs)
    return constrain(out, "batch", "model", *([None] * (out.ndim - 2)))


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              gate_up_delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN: SwiGLU (``silu``), GeGLU with the exact (erf) GELU
    (``geglu``), or an ungated GELU (tanh) / ReLU.  ``gate_up_delta``
    (geglu only): a (..., 2 d_ff) term added to the gate | up
    pre-activations (Zamba2's per-site adapter)."""
    if cfg.act == "silu":
        h = F.silu(mm(x, p["w1"])) * mm(x, p["w3"])
    elif cfg.act == "geglu":
        gate, up = mm(x, p["w1"]), mm(x, p["w3"])
        if gate_up_delta is not None:
            dg, du = torch.chunk(gate_up_delta, 2, dim=-1)
            gate, up = gate + dg, up + du
        h = F.gelu(gate) * up
    elif cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(mm(x, p["w1"]), approximate="tanh")
    else:
        h = F.relu(mm(x, p["w1"]))
    h = constrain(h, "batch", None, "model")
    return constrain(mm(h, p["w2"]), "batch", None, None)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k with capacity dispatch)
# ---------------------------------------------------------------------------


def moe_route(probs: torch.Tensor, K: int, C: int):
    """The router's choice for probabilities (T, E): the top-K weights
    (T, K) renormalised to sum to one, their expert ids (T, K), and each
    of the T K assignments' flat expert id, slot in its expert's buffer and
    whether it fits below the capacity C (token-major order).

    The top K is the first K of a stable descending sort, so among equal
    probabilities the lower expert id comes first, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order for ties).  An
    assignment's slot counts the earlier assignments to the same expert.
    Every size is static: the function runs inside a captured step."""
    E = probs.shape[-1]
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[:, :K], gate_idx[:, :K]
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    flat_idx = gate_idx.reshape(-1)                             # (T*K,)
    onehot = (flat_idx[:, None] == torch.arange(E, device=probs.device)) \
        .to(torch.int32)                                        # (T*K, E)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_e, 1, flat_idx[:, None])[:, 0]
    return gate_w, gate_idx, flat_idx, pos, pos < C


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25, with_aux: bool = False):
    """Top-k token-choice MoE with per-expert capacity (the JAX package's
    ``moe_apply``).  x: (B, S, D).  Returns (out (B, S, D), the Switch-style
    load-balance loss, or None unless ``with_aux``).

    Dispatch: each kept (token, k) assignment writes its token row into
    slot ``pos`` of its expert's (C, D) buffer.  The JAX package adds an
    assignment past the capacity as zeros at slot C - 1; here it lands in
    a spare slot C that is cut off, which leaves the same values (a kept
    slot has one writer), with no float atomics.  The expert FFN runs on
    the dequantized expert weights (``maybe_dequant``; the JAX package's
    einsums, outside any kernel).  Combine: each token's K weighted expert
    outputs are summed as a fold from k = 0, the order in which the JAX
    package's scatter-add applies them, so the sum is the same on every
    device and in every run."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    T = B * S
    expert_parallel = E % axis_divisor("model") == 0
    # Non-expert-parallel (E doesn't divide the axis): token dims sharded
    # over the batch axes throughout; the expert-parallel path must not get
    # these (they fight the E-sharded dispatch), as in the JAX package.
    tok = (lambda a: constrain(a, "batch", *([None] * (a.ndim - 1)))) \
        if not expert_parallel else (lambda a: a)
    xt = tok(x.reshape(T, D))
    gate_logits = mm(xt, p["router"]).to(torch.float32)         # (T, E)
    probs = torch.softmax(gate_logits, dim=-1)
    C = max(int(math.ceil(T * K / E * capacity_factor)), 1)
    gate_w, gate_idx, flat_idx, pos, keep = moe_route(probs, K, C)
    aux = None
    if with_aux:
        me = torch.mean(probs, dim=0)
        ce = torch.mean(F.one_hot(gate_idx[:, 0], E).to(torch.float32), dim=0)
        aux = E * torch.sum(me * ce)

    tok_ids = torch.arange(T, device=x.device)[:, None].expand(T, K) \
        .reshape(-1)
    buf = xt.new_zeros((E, C + 1, D))
    buf.index_put_((flat_idx, torch.where(keep, pos, C).long()), xt[tok_ids])
    buf = buf[:, :C]
    safe_pos = torch.where(keep, pos, C - 1).long()
    # two MoE layouts, as the param rules of launch/steps place the
    # experts: expert parallel (E sharded), or per-expert tensor parallel
    buf = constrain(buf, "model", None, None) if expert_parallel \
        else constrain(buf, None, "batch", None)

    w1 = maybe_dequant(p["w1"])
    if cfg.act == "silu":
        h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf,
                                                   maybe_dequant(p["w3"]))
    else:
        h = F.gelu(torch.bmm(buf, w1), approximate="tanh")
    h = constrain(h, "model", None, None) if expert_parallel \
        else constrain(h, None, "batch", "model")
    eout = torch.bmm(h, maybe_dequant(p["w2"]))                 # (E, C, D)
    eout = constrain(eout, "model", None, None) if expert_parallel \
        else constrain(eout, None, "batch", None)

    gathered = eout[flat_idx, safe_pos]                         # (T*K, D)
    gathered = tok(torch.where(keep[:, None], gathered,
                               torch.zeros((), dtype=gathered.dtype,
                                           device=x.device)))
    w = gate_w.reshape(-1)[:, None].to(gathered.dtype)
    contrib = (gathered * w).reshape(T, K, D)
    out = torch.zeros((T, D), dtype=xt.dtype, device=x.device)
    for k in range(K):
        out = out + contrib[:, k]
    return tok(out).reshape(B, S, D), aux

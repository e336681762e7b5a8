"""Shared building blocks of the dense transformer (port of the dense
subset of ``repro.models.common``): norms, rotary embeddings, GQA
attention (prefill, and decode over a slot cache or a paged arena), FFN.

Functions take params explicitly, as in the JAX package, with tensors in
the JAX package's layouts.  Prefill attention is plain matmul/softmax (it
is plain XLA in the JAX package); decode attention goes through
``kernels.ops.flash_decode`` / ``flash_decode_paged``, or, for int8
projections, the fused ``flash_decode_fused`` / ``flash_decode_fused_paged``
(``use_kernel``, the default; switching it off is for CPU tensors only).
Cache writes update the cache tensors in place (the JAX package returns new
arrays): a decode step then costs no cache copy.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.quant.ptq import QTensor, dequantize

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
    return {
        "wq": dense_init(gen, (dm, cfg.n_heads * dh), 0, dtype),
        "wk": dense_init(gen, (dm, cfg.n_kv_heads * dh), 0, dtype),
        "wv": dense_init(gen, (dm, cfg.n_kv_heads * dh), 0, dtype),
        "wo": dense_init(gen, (cfg.n_heads * dh, dm), 0, dtype),
    }


def make_ffn_params(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    dm, df = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (dm, df), 0, dtype)}
    if cfg.act == "silu":   # gated (SwiGLU)
        p["w3"] = dense_init(gen, (dm, df), 0, dtype)
    p["w2"] = dense_init(gen, (df, dm), 0, dtype)
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
    return y.to(x.dtype)


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


def qkv_proj(p: Params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, use_rope: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,nh,dh), k/v (B,S,nkv,dh)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    q = mm(x, p["wq"]).reshape(B, S, cfg.n_heads, dh)
    k = mm(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = mm(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, nh, dh); k, v: (B, Sk, nkv, dh); mask broadcastable to
    (B, nkv, G, Sq, Sk) with True = attend.  Returns (B, Sq, nh, dh).
    Logits and the weighted sum accumulate in float32; the probabilities
    are rounded to v's type first, as in the JAX package."""
    B, Sq, nh, dh = q.shape
    nkv = k.shape[2]
    G = nh // nkv
    qg = q.reshape(B, Sq, nkv, G, dh).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) \
        * (1.0 / math.sqrt(dh))
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


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int = 0,
                             chunk: int = 512,
                             q_offset: int = 0) -> torch.Tensor:
    """Blocked causal attention: a loop over query chunks, so the S x S
    score matrix never materializes; the direct masked form for short
    sequences.  q: (B,S,nh,dh), k/v: (B,Sk,nkv,dh)."""
    B, S, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    if S <= chunk or S % chunk:
        return gqa_attention(q, k, v, causal_mask(S, Sk, window, q_offset,
                                                  q.device))
    k_r = (k.repeat_interleave(G, dim=2) if G > 1 else k).to(torch.float32)
    v_r = (v.repeat_interleave(G, dim=2) if G > 1 else v).to(torch.float32)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for i in range(S // chunk):
        qb = q[:, i * chunk:(i + 1) * chunk].to(torch.float32)
        logits = torch.einsum("bqhd,bshd->bhqs", qb, k_r) * (1.0 / math.sqrt(dh))
        qpos = (i * chunk + q_offset) + torch.arange(chunk, device=q.device)[:, None]
        m = kpos <= qpos
        if window > 0:
            m &= kpos > qpos - window
        logits = logits.masked_fill(~m[None, None], -1e30)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs, v_r).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Decode attention over a slot cache
# ---------------------------------------------------------------------------
# Cache layout per layer: k/v (B, W, nkv, dh), W = cache capacity.
# Position p writes slot p % W; rope is applied before caching, so a
# validity count suffices for masking.


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                k1: torch.Tensor, v1: torch.Tensor, pos) -> None:
    """Write one token's k/v (B,1,nkv,dh) at slot pos % W, in place
    (``index_copy_`` at a device index: pos is an int, a 0-d tensor or a
    ``DecodePos``)."""
    W = cache_k.shape[1]
    slot = kops.decode_pos(pos, k1.device).derive(
        ("slot", W), lambda p: (p % W).reshape(1).long())
    cache_k.index_copy_(1, slot, k1.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v1.to(cache_v.dtype))


def _rope_positions(dp, B: int) -> torch.Tensor:
    """The (B, 1) int32 rope positions of a decode step (a view)."""
    return dp.derive(("rope_pos", B), lambda p: p.reshape(1, 1).expand(B, 1))


def _valid_mask(n_valid: torch.Tensor, W: int) -> torch.Tensor:
    """(B, 1, 1, 1, W) mask of the slots below each row's n_valid, in the
    layout ``gqa_attention`` broadcasts."""
    slots = torch.arange(W, device=n_valid.device)
    return (slots[None, :] < n_valid[:, None])[:, None, None, None, :]


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                     use_rope: bool = True, use_kernel: bool = True
                     ) -> torch.Tensor:
    """One-token decode step.  x: (B, 1, D); pos: the current position, a
    host int, an int32 0-d tensor on x's device or a ``kops.DecodePos``
    (all three take the same tensor code, so they give the same bits).
    Writes the token into the cache in place; returns the attention output
    (B, 1, D).  With ``use_kernel``, int8 projections that
    ``kops.fusable_decode`` admits take the fused tier
    (``flash_decode_fused``), others ``flash_decode``.
    ``use_kernel=False`` takes the plain masked softmax, which serves CPU
    tensors only: on a CUDA tensor decode attention is a kernel."""
    if not use_kernel and x.is_cuda:
        raise ValueError("use_kernel=False: the plain decode attention "
                         "runs on the CPU only; CUDA tensors go through "
                         "the flash_decode kernel")
    B = x.shape[0]
    dp = kops.decode_pos(pos, x.device)
    if use_kernel and kops.fusable_decode(p, cfg):
        # fused tier (K6): projections, rope, attention over the pre-write
        # cache plus the current token, and wo in one call; then the write
        o, k1, v1 = kops.flash_decode_fused(
            x[:, 0], p["wq"], p["wk"], p["wv"], p["wo"], cache_k, cache_v,
            dp, rope_theta=cfg.rope_theta, use_rope=use_rope)
        cache_write(cache_k, cache_v, k1[:, None], v1[:, None], dp)
        return o[:, None]
    q, k1, v1 = qkv_proj(p, cfg, x, _rope_positions(dp, B), use_rope)
    cache_write(cache_k, cache_v, k1, v1, dp)
    W = cache_k.shape[1]
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    if use_kernel:
        out = kops.flash_decode(q[:, 0], cache_k, cache_v, n_valid)[:, None]
    else:
        out = gqa_attention(q, cache_k, cache_v, _valid_mask(n_valid, W))
    return mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])


def decode_attention_cache(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor], pos,
                           use_kernel: bool = True) -> torch.Tensor:
    """Dict-cache decode step ({"k", "v"} float cache; updated in place).
    The int8 KV cache (kv_bits=8) is not ported yet."""
    if cfg.kv_bits == 8:
        raise NotImplementedError("int8 KV cache (kv_bits=8) is not ported yet")
    return decode_attention(p, cfg, x, cache["k"], cache["v"], pos,
                            use_kernel=use_kernel)


def decode_attention_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           pages: Dict[str, torch.Tensor],
                           table: torch.Tensor, pos,
                           use_kernel: bool = True) -> torch.Tensor:
    """One-token decode step over a PAGED cache.

    pages: one layer's view of the node-wide arena, {"k", "v"} of shape
    (P, block_tokens, nkv', dh'); table: (B, n_b) int32 on x's device,
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
    only)."""
    if cfg.kv_bits == 8:
        raise NotImplementedError("int8 KV cache (kv_bits=8) is not ported yet")
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
    page = dp.derive(("page", bt), lambda p: torch.index_select(
        table, 1, (p // bt).reshape(1).long())[:, 0].long())      # (B,)
    off = dp.derive(("offset", bt, B),
                    lambda p: (p % bt).reshape(1).expand(B).long())
    if use_kernel and kops.fusable_decode(p, cfg):
        # fused tier (K7) over the pre-write pages, then the write
        o, k1, v1 = kops.flash_decode_fused_paged(
            x[:, 0], p["wq"], p["wk"], p["wv"], p["wo"], pk[..., :nkv, :dh],
            pv[..., :nkv, :dh], table, dp, rope_theta=cfg.rope_theta)
        pk[..., :nkv, :dh].index_put_((page, off), k1.to(pk.dtype))
        pv[..., :nkv, :dh].index_put_((page, off), v1.to(pv.dtype))
        return o[:, None]
    q, k1, v1 = qkv_proj(p, cfg, x, _rope_positions(dp, B))
    pk[..., :nkv, :dh].index_put_((page, off), k1[:, 0].to(pk.dtype))
    pv[..., :nkv, :dh].index_put_((page, off), v1[:, 0].to(pv.dtype))
    n_valid = dp.per_row(("n_valid", W), B,
                         lambda p: torch.clamp(p + 1, max=W))
    kc, vc = pk[..., :nkv, :dh], pv[..., :nkv, :dh]
    if use_kernel:
        out = kops.flash_decode_paged(q[:, 0], kc, vc, table, n_valid)[:, None]
    else:
        idx = table.long()
        kd = kc[idx].reshape(B, W, nkv, dh)
        vd = vc[idx].reshape(B, W, nkv, dh)
        out = gqa_attention(q, kd, vd, _valid_mask(n_valid, W))
    return mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])


def prefill_cache_from_kv(k: torch.Tensor, v: torch.Tensor, W: int,
                          out: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the slot cache from prefill k/v (B, S, nkv, dh): position p
    lands at slot p % W; only the last W positions survive.  ``out``: a
    (k, v) cache of shape (B, W, nkv, dh) to fill in place (zeroed first),
    for a decode loop whose cache keeps its address."""
    B, S, nkv, dh = k.shape
    if out is None:
        ck = torch.zeros((B, W, nkv, dh), dtype=k.dtype, device=k.device)
        cv = torch.zeros((B, W, nkv, dh), dtype=v.dtype, device=v.device)
    else:
        ck, cv = out
        ck.zero_()
        cv.zero_()
    start = max(0, S - W)
    slots = torch.arange(start, S, device=k.device) % W
    ck[:, slots] = k[:, start:]
    cv[:, slots] = v[:, start:]
    return ck, cv


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(mm(x, p["w1"])) * mm(x, p["w3"])
    elif cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(mm(x, p["w1"]), approximate="tanh")
    else:
        h = F.relu(mm(x, p["w1"]))
    return mm(h, p["w2"])

"""Public kernel entry points (port of ``repro.kernels.ops``).

Model code calls only these.  Each routes by where its tensors lie: a
CUDA tensor goes to the hand-written kernel (which raises on what it does
not take; there is no fallback), a CPU tensor to the kernel's plain
PyTorch version.  Any other device raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import decode_glue as _dg
from repro_torch.kernels import decode_loop as _dl
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import mamba2_decode as _md
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.quant.ptq import QTensor, quantize_rowwise


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


_COUNTERS = (_qm.LAUNCHES, _fd.LAUNCHES, _dg.LAUNCHES, _dl.LAUNCHES,
             _md.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {k: v for d in _COUNTERS for k, v in d.items()}


def reset_launch_counts() -> None:
    for d in _COUNTERS:
        for k in d:
            d[k] = 0


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the launch counters: the launches of a
    captured step, once for each iteration a device loop ran it (a
    replay runs no wrapper)."""
    for d in _COUNTERS:
        for k in d:
            d[k] += times * counts.get(k, 0)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 bits: int = 8, act_bits: int = 16) -> torch.Tensor:
    """x (..., K) @ dequant(q, scale) -> (..., N) in x.dtype.

    ``act_bits=8`` (with ``bits=8``) runs the W8A8 tier: x is quantized
    per row (absmax/127 over the full K axis) here, outside the kernel, and
    the kernel takes int8 operands and one (M, 1) scale."""
    *lead, K = x.shape
    scale = scale.reshape(-1)
    N = scale.shape[0]
    x2 = x.reshape(-1, K)
    if act_bits == 8 and bits == 8:
        xq, sx = quantize_rowwise(x2)
        if _on_cuda(x2):
            out = _qm.quant_matmul_a8_cuda(xq, sx, q, scale, x.dtype)
        else:
            out = _qm.quant_matmul_a8_plain(xq, sx, q, scale, x.dtype)
    elif _on_cuda(x2):
        out = _qm.quant_matmul_cuda(x2.contiguous(), q, scale, bits)
    else:
        out = _qm.quant_matmul_plain(x2, q, scale, bits)
    return out.reshape(*lead, N)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """Dispatch on weight type: QTensor -> quantized tiers; tensor -> x @ w.
    QTensor leaves tagged ``act_bits=8`` route to the W8A8 tier."""
    if isinstance(w, QTensor):
        return quant_matmul(x, w.q, w.scale, w.bits, act_bits=w.act_bits)
    return x @ w


class DecodePos:
    """The position of a decode step, as one int32 0-d tensor on the step's
    device, and what the decode-attention tiers derive from it (the cache
    slot, the valid-slot counts, the evicted slot, the rope rows), each
    made once a step and shared by every layer.  A host int goes through
    the same tensor code, so the two forms give the same bits; a CUDA graph
    captured on a device position replays at whatever position it holds."""

    def __init__(self, pos, device):
        if isinstance(pos, torch.Tensor):
            self.pos = pos.reshape(())
        else:
            self.pos = torch.full((), int(pos), dtype=torch.int32,
                                  device=device)
        self._memo: Dict[tuple, object] = {}

    def derive(self, key: tuple, fn):
        """``fn(pos)``, made once for each ``key``."""
        if key not in self._memo:
            self._memo[key] = fn(self.pos)
        return self._memo[key]

    def per_row(self, key: tuple, B: int, fn) -> torch.Tensor:
        """``fn(pos)`` as a contiguous (B,) int32 tensor, one value for
        every row (the kernels' per-row pointer form)."""
        return self.derive(key + (B,), lambda p: fn(p).to(torch.int32)
                           .reshape(1).expand(B).contiguous())


def decode_pos(pos, device) -> DecodePos:
    """``pos`` (a host int, an int32 0-d tensor or a :class:`DecodePos`) as
    a :class:`DecodePos`."""
    return pos if isinstance(pos, DecodePos) else DecodePos(pos, device)


def rope_positions(dp: DecodePos, B: int) -> torch.Tensor:
    """The (B, 1) int32 rope positions of a decode step (a view)."""
    return dp.derive(("rope_pos", B), lambda p: p.reshape(1, 1).expand(B, 1))


def cache_slot(dp: DecodePos, W: int) -> torch.Tensor:
    """The slot pos % W of a slab cache of W slots, as a (1,) int64."""
    return dp.derive(("slot", W), lambda p: (p % W).reshape(1).long())


def page_index(dp: DecodePos, table: torch.Tensor, bt: int, B: int):
    """(page, offset) (B,) int64 of a decode step's write into pages of
    ``bt`` slots: page ``table[b, pos // bt]``, offset ``pos % bt``."""
    page = dp.derive(("page", bt), lambda p: torch.index_select(
        table, 1, (p // bt).reshape(1).long())[:, 0].long())
    off = dp.derive(("offset", bt, B),
                    lambda p: (p % bt).reshape(1).expand(B).long())
    return page, off


def add_norm(x: torch.Tensor, y, w, kind: str, eps: float = 1e-5):
    """A decode layer's residual add and the norm after it: (x + y, the
    ``kind`` norm of x + y with weight ``w``), or (x, the norm of x) with
    ``y`` None; x, y (..., D).  On CUDA one launch of ``add_norm``."""
    if _on_cuda(x):
        return _dg.add_norm_cuda(x, y, w, kind, eps)
    return _dg.add_norm_plain(x, y, w, kind, eps)


def mamba2_decode(proj: torch.Tensor, conv_state: torch.Tensor,
                  ssm: torch.Tensor, p: dict, n_groups: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """One Mamba2 layer's decode step after its input projection ``proj``
    (B, d_proj), with the layer's params ``p``: the conv and SSM states
    updated in place, the gated, group-normalized y (B, d_inner)
    returned.  CUDA tensors only (two launches); the CPU takes its plain
    version, ``models.mamba2.decode_between``."""
    if not _on_cuda(proj):
        raise ValueError("mamba2_decode: CUDA tensors only; on the CPU "
                         "models.mamba2.decode_between runs its op chain")
    return _md.mamba2_decode_cuda(proj, conv_state, ssm, p["conv_w"],
                                  p.get("conv_b"), p["dt_bias"], p["A_log"],
                                  p["D"], p["gate_norm"], n_groups, eps)


def rope_qk_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                  theta: float, k_dst: torch.Tensor, v_dst: torch.Tensor,
                  table: torch.Tensor = None,
                  use_rope: bool = True) -> torch.Tensor:
    """One decode token's q (B, 1, nh, dh), k and v (B, 1, nkv, dh) at
    position ``pos`` (a host int, an int32 0-d tensor or a
    :class:`DecodePos`): q and k rotated (``use_rope``), k and v written in
    place into a slab cache (B, W, nkv, dh) at slot pos % W, or, with a
    block ``table`` (B, n_b), into page ``table[b, pos // bt]`` at offset
    ``pos % bt`` of the page views (P, bt, nkv, dh); returns the rotated
    q.  On CUDA one launch of ``rope_qk_write``."""
    dp = decode_pos(pos, q.device)
    if _on_cuda(q):
        freqs = _dg.rope_table(q.shape[-1], theta, q.device)
        return _dg.rope_qk_write_cuda(q, k, v, dp.pos, freqs, k_dst, v_dst,
                                      table, use_rope)
    B = q.shape[0]
    index = cache_slot(dp, k_dst.shape[1]) if table is None \
        else page_index(dp, table, k_dst.shape[1], B)
    return _dg.rope_qk_write_plain(q, k, v, rope_positions(dp, B), k_dst,
                                   v_dst, index, theta, use_rope)


def _rope_rows(pos, dh: int, theta: float, device):
    """cos/sin (1, dh/2) float32 rows for decode position ``pos`` (an int
    or a 0-d tensor; the angle convention of ``models.common.apply_rope``),
    made once here so that the slab and the paged fused kernels see the
    same rows.  A position below 2^24 is exact in float32, so
    ``freqs * float(pos)`` and ``freqs * pos.float()`` round alike."""
    freqs = _dg.rope_freqs(dh, theta, device)
    if isinstance(pos, torch.Tensor):
        ang = freqs * pos.to(torch.float32)
    else:
        ang = freqs * float(pos)
    return torch.cos(ang).reshape(1, -1), torch.sin(ang).reshape(1, -1)


def fusable_decode(p, cfg) -> bool:
    """Whether a layer's attention takes the fused quantized decode tier
    (K6, and K7 over the paged arena): all four projections are int8
    QTensors (W8A16 or W8A8; int4 stays on the unfused tier), no qk-norm
    (it sits between projection and rope, which the fused kernel does not
    model), and ``d_head % 128 == 0``.  The last condition is the JAX
    package's tier choice on its accelerator, where 128 is the lane width;
    the port serves each model on the tier the reference serves it on (so
    BLOOM-3B, d_head 80, keeps the unfused K1 + K4/K5 path).  It is a
    dispatch rule, not a limit of the kernel, which takes any even d_head;
    and it does not depend on the device, so the CPU and the card take the
    same tier."""
    ws = [p.get("wq"), p.get("wk"), p.get("wv"), p.get("wo")]
    return (all(isinstance(w, QTensor) and w.bits == 8 for w in ws)
            and not cfg.qk_norm and cfg.d_head % 128 == 0)


def decode_kernel_tier(p, cfg) -> str:
    """Which decode-attention tier a kernel-routed step takes for layer
    params ``p`` under ``cfg``: ``"kv8"`` for an int8 KV cache (``kv_bits
    == 8``: the cache is dequantized and attention is the plain masked
    softmax, no decode-attention kernel, as in the JAX package),
    ``"fused"`` (``flash_decode_fused[_paged]``) when ``fusable_decode``
    holds, else ``"flash"`` (``flash_decode[_paged]``)."""
    if cfg.kv_bits == 8:
        return "kv8"
    return "fused" if fusable_decode(p, cfg) else "flash"


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: Union[int, torch.Tensor],
                 scale: Optional[float] = None) -> torch.Tensor:
    """GQA decode attention: q (B, nh, dh) against k/v (B, W, nkv, dh);
    slots >= n_valid (int or (B,) int32) are masked; the logits are scaled
    by ``scale`` (None: 1/sqrt(dh))."""
    if _on_cuda(q):
        return _fd.flash_decode_cuda(q.contiguous(), k, v, n_valid, scale)
    return _fd.flash_decode_plain(q, k, v, n_valid, scale)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """``flash_decode`` read through a block table: q (B, nh, dh) against
    k/v pages (P, bt, nkv, dh) (possibly the leading-corner view of a wider
    page tail), where slot j of row b lives in page ``table[b, j // bt]``
    at offset ``j % bt``; slots >= n_valid are masked."""
    if _on_cuda(q):
        return _fd.flash_decode_paged_cuda(q.contiguous(), k_pages, v_pages,
                                           table, n_valid)
    return _fd.flash_decode_paged_plain(q, k_pages, v_pages, table, n_valid)


def _fused_operands(x, wq, wk, wv, wo, W: int, pos, dh: int,
                    rope_theta: float):
    """The fused kernels' operands from QTensor projections and a position
    (an int, a 0-d tensor or a :class:`DecodePos`): the int8 weights and
    flat scales, n_valid = min(pos, W) and the slot the current token will
    overwrite (pos % W once pos >= W, else -1) as (B,) int32 tensors, and
    the rope rows."""
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if not isinstance(w, QTensor) or w.bits != 8:
            raise ValueError(f"{name}: the fused tier takes int8 QTensors")
    dp = decode_pos(pos, x.device)
    B = x.shape[0]
    nv = dp.per_row(("fused_nv", W), B, lambda p: torch.clamp(p, max=W))
    ev = dp.per_row(("fused_ev", W), B,
                    lambda p: torch.where(p >= W, p % W, -1))
    cos, sin = dp.derive(("rope", dh, rope_theta),
                         lambda p: _rope_rows(p, dh, rope_theta, x.device))
    ws = []
    for w in (wq, wk, wv, wo):
        ws += [w.q, w.scale.reshape(-1)]
    return ws, nv, ev, cos, sin, wq.act_bits == 8


def flash_decode_fused(x: torch.Tensor, wq, wk, wv, wo,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       pos, rope_theta: float = 1e4,
                       use_rope: bool = True):
    """Fused quantized decode attention over a slot cache (K6).

    x (B, D) pre-norm hidden rows; wq/wk/wv/wo int8 QTensors (W8A8 when
    they carry ``act_bits=8``); caches (B, W, nkv, dh) PRE-write; pos the
    current position (a host int, an int32 0-d tensor on x's device or a
    :class:`DecodePos`).  Returns (o (B, D), k1, v1
    (B, nkv, dh)); the CALLER writes k1/v1 at slot pos % W."""
    W, dh = cache_k.shape[1], cache_k.shape[3]
    ws, nv, ev, cos, sin, a8 = _fused_operands(x, wq, wk, wv, wo, W, pos,
                                               dh, rope_theta)
    if _on_cuda(x):
        return _fd.flash_decode_fused_cuda(x.contiguous(), *ws, cache_k,
                                           cache_v, nv, ev, cos, sin,
                                           use_rope, a8)
    return _fd.flash_decode_fused_plain(x, *ws, cache_k, cache_v, nv, ev,
                                        cos, sin, use_rope, a8)


def flash_decode_fused_paged(x: torch.Tensor, wq, wk, wv, wo,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             table: torch.Tensor, pos,
                             rope_theta: float = 1e4,
                             use_rope: bool = True):
    """``flash_decode_fused`` read through a block table (K7): k/v pages
    (P, bt, nkv, dh) (possibly the leading-corner view of a wider page
    tail), table (B, n_b) int32.  Returns (o, k1, v1); the caller writes
    k1/v1 into page ``table[b, pos // bt]`` at offset ``pos % bt``."""
    W, dh = table.shape[1] * k_pages.shape[1], k_pages.shape[3]
    ws, nv, ev, cos, sin, a8 = _fused_operands(x, wq, wk, wv, wo, W, pos,
                                               dh, rope_theta)
    if _on_cuda(x):
        return _fd.flash_decode_fused_paged_cuda(
            x.contiguous(), *ws, k_pages, v_pages, table, nv, ev, cos, sin,
            use_rope, a8)
    return _fd.flash_decode_fused_paged_plain(x, *ws, k_pages, v_pages,
                                              table, nv, ev, cos, sin,
                                              use_rope, a8)

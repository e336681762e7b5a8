"""The elementwise chains of a transformer decode layer: the CUDA kernels
and their plain versions.

The kernels (``csrc/decode_glue.cu``) take the place of PyTorch op chains
that the JAX package leaves to XLA's fusion: ``add_norm`` is the residual
add and the norm after it (``models.common.apply_norm``), ``rope_qk_write``
is rope on one decode token's q and k (``models.common.apply_rope``) with
its k and v written into the cache (a slab's slot ``pos % W``, or page
``table[b, pos // bt]`` at offset ``pos % bt`` of an arena view).
``add_norm_cuda`` and ``rope_qk_write_cuda`` launch them on CUDA tensors
and count their launches in ``LAUNCHES``; ``add_norm_plain`` and
``rope_qk_write_plain`` are those op chains, as the model ran them before,
which the CPU path takes.

The kernels compute in float32 with the chains' operations in their order
and round where the chains round: ``x + y`` is bitwise PyTorch's add;
a norm's means are fixed-order block sums, so ``h`` may differ from the
chain's by one ulp of its type.  Rope's cos and sin are those of
``float(pos) * freqs`` with ``freqs`` the float32 table of ``rope_freqs``,
made once for each (d_head, theta, device) outside any capture
(``rope_table``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build

LAUNCHES = {"add_norm": 0, "rope_qk_write": 0}

# add_norm: rows of at most MAX_THREADS * AN_PER elements (csrc: a block of
# up to 1024 threads, each holding at most 16 of its row's elements)
AN_MAX_THREADS = 1024
AN_PER = 16

_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def add_norm_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                   w: Optional[torch.Tensor], kind: str,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new, h): x_new = x + y (x itself without y), h = the norm of
    x_new over its last axis in float32, rounded to x's type: the op chain
    of ``models.common.apply_norm`` (rmsnorm, or layernorm for every other
    kind; ``w`` None for a norm without a weight)."""
    if y is not None:
        x = x + y
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        h = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        h = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        h = h * w.to(torch.float32)
    return x, h.to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """The (d_head / 2,) float32 rope frequencies, ``models.common
    .rope_freqs``' op chain."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def rope_table(d_head: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, made once and kept.  It is made on the
    first call, which must not lie inside a CUDA graph capture (a serving
    engine's warm-up step makes it)."""
    key = (int(d_head), float(theta), torch.device(device))
    if key not in _FREQS:
        if key[2].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"rope_table({d_head}, {theta}): the table is made outside "
                f"a capture; run one decode step before capturing one")
        _FREQS[key] = rope_freqs(d_head, theta, key[2])
    return _FREQS[key]


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            theta: float) -> torch.Tensor:
    """``models.common.apply_rope``'s op chain: split halves, (x1, x2) ->
    (x1 cos - x2 sin, x1 sin + x2 cos) in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_qk_write_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, k_dst: torch.Tensor,
                        v_dst: torch.Tensor, index, theta: float,
                        use_rope: bool = True) -> torch.Tensor:
    """One decode token's q (B, 1, nh, dh), k and v (B, 1, nkv, dh): q and
    k rotated at ``positions`` (B, 1) (``use_rope``), k and v written in
    place, and the rotated q returned.  ``index``: the slot (1,) int64 of
    a slab cache (B, W, nkv, dh) (``index_copy_``), or (page, offset) (B,)
    int64 into arena views (P, bt, nkv, dh) (``index_put_``)."""
    if use_rope:
        q, k = _rotate(q, positions, theta), _rotate(k, positions, theta)
    if isinstance(index, tuple):
        k_dst.index_put_(index, k[:, 0].to(k_dst.dtype))
        v_dst.index_put_(index, v[:, 0].to(v_dst.dtype))
    else:
        k_dst.index_copy_(1, index, k.to(k_dst.dtype))
        v_dst.index_copy_(1, index, v.to(v_dst.dtype))
    return q


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def add_norm_threads(D: int) -> int:
    """add_norm's block width for rows of D: a multiple of 32 with about
    four elements a thread, from 128 up to 1024 threads."""
    if D > AN_MAX_THREADS * AN_PER:
        raise ValueError(f"add_norm: rows of {D} > "
                         f"{AN_MAX_THREADS * AN_PER} elements")
    quarter = -(-D // 4)
    return min(AN_MAX_THREADS, max(128, (quarter + 31) // 32 * 32))


def add_norm_cuda(x: torch.Tensor, y: Optional[torch.Tensor],
                  w: Optional[torch.Tensor], kind: str,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``add_norm_plain``'s function in one launch: x, y (..., D) float32
    or bfloat16, w (D,) of x's type or None."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    if not x.is_cuda:
        raise ValueError(f"x: need a CUDA tensor, got one on {x.device}")
    D = x.shape[-1]
    x = x.contiguous()
    if y is not None:
        y = y.contiguous()
        _check_rows("y", y, x.dtype, x.shape)
    if w is not None:
        _check_rows("w", w, x.dtype, (D,))
    h = torch.empty_like(x)
    x_new = torch.empty_like(x) if y is not None else x
    lib = _build.library("decode_glue")
    rc = lib.add_norm(x.data_ptr(), None if y is None else y.data_ptr(),
                      None if w is None else w.data_ptr(), x_new.data_ptr(),
                      h.data_ptr(), x.numel() // D, D, add_norm_threads(D),
                      int(kind == "rmsnorm"), eps,
                      int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(rc, "add_norm")
    LAUNCHES["add_norm"] += 1
    return x_new, h


def rope_qk_write_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: Union[int, torch.Tensor], freqs: torch.Tensor,
                       k_dst: torch.Tensor, v_dst: torch.Tensor,
                       table: Optional[torch.Tensor] = None,
                       use_rope: bool = True) -> torch.Tensor:
    """``rope_qk_write_plain``'s function in one launch.  q (B, ..., nh,
    dh), k and v (B, ..., nkv, dh), one token a row, contiguous, float32 or
    bfloat16; pos an int32 0-d CUDA tensor or a host int; freqs
    ``rope_table``'s (dh / 2,) float32.  Slab (``table`` None): k_dst,
    v_dst (B, W, nkv, dh) contiguous.  Paged: k_dst, v_dst (P, bt, nkv,
    dh) views with a contiguous last axis and the same strides, table (B,
    n_b) int32.  Returns the rotated q in q's shape."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    B, nh, dh = q.shape[0], q.shape[-2], q.shape[-1]
    nkv = k.shape[-2]
    if dh % 2:
        raise ValueError(f"d_head={dh} must be even")
    _check_rows("q", q, q.dtype, q.shape)
    if q.numel() != B * nh * dh:
        raise ValueError(f"q: one token a row, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        _check_rows(name, t, q.dtype, t.shape)
        if t.numel() != B * nkv * dh or t.shape[-1] != dh:
            raise ValueError(f"{name}: need one token of (B={B}, nkv={nkv}, "
                             f"dh={dh}), got {tuple(t.shape)}")
    _check_rows("freqs", freqs, torch.float32, (dh // 2,))
    if isinstance(pos, torch.Tensor):
        _check_rows("pos", pos, torch.int32, ())
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, int(pos)
    if table is None:
        W = k_dst.shape[1]
        for name, t in (("k_dst", k_dst), ("v_dst", v_dst)):
            _check_rows(name, t, q.dtype, (B, W, nkv, dh))
        n_b = bt = 0
        strides = (0, 0, 0)
    else:
        if k_dst.dim() != 4:
            raise ValueError(f"k_dst: need (P, bt, nkv, dh), got "
                             f"{tuple(k_dst.shape)}")
        P, bt = k_dst.shape[:2]
        for name, t in (("k_dst", k_dst), ("v_dst", v_dst)):
            if not t.is_cuda or t.dtype != q.dtype \
                    or tuple(t.shape) != (P, bt, nkv, dh) or t.stride(3) != 1 \
                    or t.stride() != k_dst.stride():
                raise ValueError(f"{name}: need a CUDA {q.dtype} tensor of "
                                 f"shape {(P, bt, nkv, dh)} with a contiguous "
                                 f"last axis and k_dst's strides, got "
                                 f"{t.dtype} {tuple(t.shape)} strides "
                                 f"{t.stride()} on {t.device}")
        if not table.is_cuda or table.dtype != torch.int32 \
                or table.dim() != 2 or table.shape[0] != B \
                or not table.is_contiguous():
            raise ValueError(f"table: need a contiguous CUDA int32 (B={B}, "
                             f"n_b) tensor, got {table.dtype} "
                             f"{tuple(table.shape)} on {table.device}")
        W, n_b = 0, table.shape[1]
        strides = k_dst.stride()[:3]
    q_out = torch.empty_like(q)
    lib = _build.library("decode_glue")
    rc = lib.rope_qk_write(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), freqs.data_ptr(), pos_ptr,
        pos_scalar, q_out.data_ptr(), k_dst.data_ptr(), v_dst.data_ptr(),
        None if table is None else table.data_ptr(), B, nh, nkv, dh,
        int(use_rope), W, n_b, bt, *strides, int(q.dtype == torch.bfloat16),
        _stream(q))
    _build.check(rc, "rope_qk_write")
    LAUNCHES["rope_qk_write"] += 1
    return q_out

"""Quantized matmul tiers (W8A16 / W4A16 / W8A8): CUDA kernels and their
plain PyTorch versions.

The kernels (``csrc/quant_matmul.cu``) replace the Pallas TPU kernels of
``repro/kernels/quant_matmul.py`` (``_mm_kernel_int8``, ``_mm_kernel_int4``,
``_mm_kernel_w8a8``).  ``quant_matmul_cuda`` / ``quant_matmul_a8_cuda``
launch them on CUDA tensors and count their launches in ``LAUNCHES``;
``quant_matmul_plain`` / ``quant_matmul_a8_plain`` are the same functions in
plain PyTorch (twins of ``repro/kernels/ref.py``), which the CPU path and
the on-card comparisons use.

Shapes: x (M, K); q int8 (K, N), or for bits=4 packed (ceil(K/2), N);
scale (N,) float32.  The W8A8 tier takes x already quantized per row
(``ptq.quantize_rowwise``): xq int8 (M, K) and sx (M, 1) float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.quant.ptq import unpack_int4

LAUNCHES = {"w8a16": 0, "w4a16": 0, "w8a8": 0}

_SKINNY_ROWS = 8        # csrc: SK_ROWS, rows of x per skinny block
_SKINNY_COLS = 128      # csrc: SK_BN, columns per skinny block
_SPLIT_QUANTUM = 256    # csrc: SK_KC, k values staged per pass
_TARGET_BLOCKS = 264    # two blocks for each of the H100's 132 SMs


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       bits: int = 8) -> torch.Tensor:
    """x (M,K) @ dequant(q, scale) -> (M,N) in x.dtype (f32 arithmetic)."""
    if bits == 4:
        q = unpack_int4(q)[:x.shape[-1]]
    w = q.to(torch.float32) * scale.to(torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


def a8_accumulate_plain(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product xq (M,K) int8 @ q (K,N) int8.  Computed in
    float64, where every partial sum (|acc| < 2^53) is exact, so one
    expression serves any M and either device."""
    return (xq.to(torch.float64) @ q.to(torch.float64)).to(torch.int32)


def quant_matmul_a8_plain(xq: torch.Tensor, sx: torch.Tensor,
                          q: torch.Tensor, scale: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """W8A8: exact int32 dot, then one ``float(acc) * sx * sw`` at
    writeout, cast to ``out_dtype``."""
    acc = a8_accumulate_plain(xq, q)
    out = acc.to(torch.float32) * sx.to(torch.float32) \
        * scale.reshape(1, -1).to(torch.float32)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _splits(M: int, N: int, K: int):
    """Split-K plan of the skinny (M <= 8) kernel: enough blocks to cover
    the SMs twice, each split a multiple of 256 k values."""
    if M > _SKINNY_ROWS:
        return 1, K
    blocks = math.ceil(N / _SKINNY_COLS) * math.ceil(M / _SKINNY_ROWS)
    want = max(1, min(math.ceil(_TARGET_BLOCKS / blocks),
                      K // _SPLIT_QUANTUM))
    kps = math.ceil(math.ceil(K / want) / _SPLIT_QUANTUM) * _SPLIT_QUANTUM
    return math.ceil(K / kps), kps


def _check_cuda(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def quant_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """W8A16 (bits 8) / W4A16 (bits 4) kernel: x (M, K) f32 or bf16."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    M, K = x.shape
    N = scale.numel()
    _check_cuda("x", x, x.dtype, (M, K))
    _check_cuda("q", q, torch.int8, ((K + 1) // 2 if bits == 4 else K, N))
    _check_cuda("scale", scale, torch.float32, (N,))
    splits, kps = _splits(M, N, K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, M, N) if splits > 1 else (0,),
                          dtype=torch.float32, device=x.device)
    lib = _build.library("quant_matmul")
    rc = lib.qmm_a16(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), partial.data_ptr(), M, N, K, bits,
                     int(x.dtype == torch.bfloat16), splits, kps,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "qmm_a16")
    LAUNCHES["w4a16" if bits == 4 else "w8a16"] += 1
    return out


def quant_matmul_a8_cuda(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """W8A8 kernel: xq int8 (M, K), sx (M, 1) f32 -> (M, N) out_dtype."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: expected float32 or "
                        f"bfloat16")
    M, K = xq.shape
    N = scale.numel()
    _check_cuda("xq", xq, torch.int8, (M, K))
    _check_cuda("sx", sx, torch.float32, (M, 1))
    _check_cuda("q", q, torch.int8, (K, N))
    _check_cuda("scale", scale, torch.float32, (N,))
    splits, kps = _splits(M, N, K)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    partial = torch.empty((splits, M, N) if splits > 1 else (0,),
                          dtype=torch.int32, device=xq.device)
    lib = _build.library("quant_matmul")
    rc = lib.qmm_a8(xq.data_ptr(), sx.data_ptr(), q.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), partial.data_ptr(),
                    M, N, K, int(out_dtype == torch.bfloat16), splits, kps,
                    torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(rc, "qmm_a8")
    LAUNCHES["w8a8"] += 1
    return out

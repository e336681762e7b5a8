"""Quantized matmul tiers (W8A16 / W4A16 / W8A8): CUDA kernels and their
plain PyTorch versions.

The kernels (``csrc/quant_matmul.cu``) replace the Pallas TPU kernels of
``repro/kernels/quant_matmul.py`` (``_mm_kernel_int8``, ``_mm_kernel_int4``,
``_mm_kernel_w8a8``).  ``quant_matmul_cuda`` / ``quant_matmul_a8_cuda``
launch them on CUDA tensors and count their launches in ``LAUNCHES``
(``w8a16_tc`` / ``w4a16_tc`` / ``w8a8_tc`` count the tensor-core launches,
and ``w8a16_gemv`` / ``w4a16_gemv`` / ``w8a8_gemv`` the GEMVs' at M <= 8,
a second time, beside ``w8a16`` / ``w4a16`` / ``w8a8``); ``route`` is the
plan that picks the kernel, ``gemv_a16_plan`` and ``gemv_a8_plan`` the
GEMVs' grids and splits of K;
``quant_matmul_plain`` / ``quant_matmul_a8_plain`` are the same functions in
plain PyTorch (twins of ``repro/kernels/ref.py``), which the CPU path and
the on-card comparisons use.

Shapes: x (M, K); q int8 (K, N), or for bits=4 packed (ceil(K/2), N);
scale (N,) float32.  The W8A8 tier takes x already quantized per row
(``ptq.quantize_rowwise``): xq int8 (M, K) and sx (M, 1) float32.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.quant.ptq import unpack_int4

LAUNCHES = {"w8a16": 0, "w4a16": 0, "w8a8": 0, "w8a16_tc": 0, "w4a16_tc": 0,
            "w8a8_tc": 0, "w8a16_gemv": 0, "w4a16_gemv": 0, "w8a8_gemv": 0}

_SKINNY_ROWS = 8        # csrc: SK_ROWS, rows of x per skinny block
_SKINNY_COLS = 128      # csrc: SK_BN, columns per skinny block
_SPLIT_QUANTUM = 256    # csrc: SK_KC, k values staged per pass
_TARGET_BLOCKS = 264    # two blocks for each of the H100's 132 SMs

# the GEMVs (qmm_a8_gemv, qmm_a16_gemv), constants of csrc/quant_matmul.cu,
# which the CPU tests hold equal to these
GV_WARPS = 4            # GV_WARPS, warps of a block
GV_BN = 128             # GV_BN, columns of a block: 8 lane groups x 16
GV_KSTEP = 16           # GV_KSTEP, k rows of a warp step: 4 lanes x 4 rows
GV_KSTEP4 = 32          # GV_KSTEP4, k rows of a W4 step: 16 packed rows
GV_MAX_SPLITS = 8       # GV_MAX_SPLITS, blocks of a cluster


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
    """The exact int32 product xq (M,K) int8 @ q (K,N) int8 (batched over
    leading axes, as ``@``).  Computed in float64, where every partial sum
    (|acc| < 2^53) is exact, so one expression serves any M and either
    device."""
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


class GemvPlan(NamedTuple):
    grid: Tuple[int, int]       # (column tiles, splits); a cluster is (1, splits)
    k_per_split: int            # split s sums k in [s kps, min(K, (s + 1) kps))
    workspace_bytes: int        # device scratch the launch needs


def _gemv_plan(N: int, K: int, kstep: int) -> GemvPlan:
    """Enough blocks to cover the SMs twice, at most a cluster's
    ``GV_MAX_SPLITS`` splits of a column tile, each a multiple of ``kstep``
    k rows and at least one warp step for each of the block's warps.  The
    splits of a tile merge inside their cluster: no workspace."""
    tiles = -(-N // GV_BN)
    steps = -(-K // kstep)
    want = max(1, min(GV_MAX_SPLITS, -(-_TARGET_BLOCKS // max(tiles, 1)),
                      -(-steps // GV_WARPS)))
    kps = max(1, -(-steps // want)) * kstep
    return GemvPlan((tiles, max(1, -(-K // kps))), kps, 0)


@lru_cache(maxsize=None)
def gemv_a8_plan(M: int, N: int, K: int) -> GemvPlan:
    """Grid and split of K of the W8A8 GEMV (M <= 8), from the shapes
    alone, in steps of ``GV_KSTEP`` k rows."""
    if M > _SKINNY_ROWS:
        raise ValueError(f"the W8A8 GEMV takes M <= {_SKINNY_ROWS}, got {M}")
    return _gemv_plan(N, K, GV_KSTEP)


@lru_cache(maxsize=None)
def gemv_a16_plan(N: int, K: int, bits: int) -> GemvPlan:
    """Grid and split of K of the W8A16 / W4A16 GEMV, from N, K and bits
    alone (never from M, so that each row of a call is the same row
    computed alone), in steps of ``GV_KSTEP`` k rows, or ``GV_KSTEP4`` at
    bits 4."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    return _gemv_plan(N, K, GV_KSTEP4 if bits == 4 else GV_KSTEP)


def gemv_a16_wide(x: torch.Tensor, q: torch.Tensor, bits: int) -> bool:
    """Whether the W8A16 / W4A16 GEMV can read q in 16-byte pieces and x
    in 4-byte words: N % 16 == 0, an even K at bits 4, q 16-byte and x
    4-byte aligned.  The others, like float32 x, stay on ``qmm_skinny``."""
    K, N = x.shape[1], q.shape[1]
    return (N % 16 == 0 and (bits == 8 or K % 2 == 0)
            and q.data_ptr() % 16 == 0 and x.data_ptr() % 4 == 0)


def gemv_wide(xq: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether the GEMV can read q in 16-byte pieces and xq in 4-byte
    words: N % 16 == 0, K % 4 == 0, q 16-byte and xq 4-byte aligned.  The
    others take its byte-load instantiation, bitwise the same."""
    K, N = q.shape
    return (N % 16 == 0 and K % 4 == 0 and q.data_ptr() % 16 == 0
            and xq.data_ptr() % 4 == 0)


def route(M: int, K: int, N: int, dtype: torch.dtype, bits: int,
          aligned: bool = True) -> str:
    """Which kernel ``quant_matmul_cuda`` / ``quant_matmul_a8_cuda``
    launches, from shapes and types alone: "skinny" at M <= 8 (decode:
    ``qmm_a16_gemv`` for bfloat16 x whose operands ``gemv_a16_wide``
    takes, ``qmm_a8_gemv`` for int8 xq, ``qmm_skinny`` for the rest);
    "tc", a tensor-core kernel, at M > 8 where the TMA can read the
    operands (16-byte aligned bases and row strides: N % 16 == 0 for q and
    the output, and K % 8 == 0 for bfloat16 x, K % 16 == 0 for the W8A8
    tier's int8 xq); "tiled" for the rest, float32 x among it.
    ``dtype`` is x's type (int8 for W8A8); ``aligned``: x and q start on a
    16-byte boundary."""
    if M <= _SKINNY_ROWS:
        return "skinny"
    if dtype == torch.int8:
        tma = bits == 8 and K % 16 == 0
    else:
        tma = dtype == torch.bfloat16 and bits in (4, 8) and K % 8 == 0
    return "tc" if tma and aligned and N % 16 == 0 else "tiled"


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
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.library("quant_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    name = "w4a16" if bits == 4 else "w8a16"
    if route(M, K, N, x.dtype, bits,
             x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0) == "tc":
        rc = lib.qmm_a16_tc(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                            out.data_ptr(), M, N, K, bits, stream)
        _build.check(rc, "qmm_a16_tc")
        LAUNCHES[name] += 1
        LAUNCHES[name + "_tc"] += 1
        return out
    if (M <= _SKINNY_ROWS and x.dtype == torch.bfloat16
            and gemv_a16_wide(x, q, bits)):
        plan = gemv_a16_plan(N, K, bits)
        rc = lib.qmm_a16_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), M, N, K, bits, plan.grid[1],
                              plan.k_per_split, stream)
        _build.check(rc, "qmm_a16_gemv")
        LAUNCHES[name] += 1
        LAUNCHES[name + "_gemv"] += 1
        return out
    splits, kps = _splits(M, N, K)
    partial = torch.empty((splits, M, N) if splits > 1 else (0,),
                          dtype=torch.float32, device=x.device)
    rc = lib.qmm_a16(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), partial.data_ptr(), M, N, K, bits,
                     int(x.dtype == torch.bfloat16), splits, kps, stream)
    _build.check(rc, "qmm_a16")
    LAUNCHES[name] += 1
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
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    lib = _build.library("quant_matmul")
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    bf16 = int(out_dtype == torch.bfloat16)
    if route(M, K, N, torch.int8, 8,
             xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0) == "tc":
        rc = lib.qmm_a8_tc(xq.data_ptr(), sx.data_ptr(), q.data_ptr(),
                           scale.data_ptr(), out.data_ptr(), M, N, K, bf16,
                           stream)
        _build.check(rc, "qmm_a8_tc")
        LAUNCHES["w8a8"] += 1
        LAUNCHES["w8a8_tc"] += 1
        return out
    # M <= 8: the GEMV, over the plan's splits of K; else the tiled kernel
    gemv = M <= _SKINNY_ROWS
    if gemv:
        plan = gemv_a8_plan(M, N, K)
        split = (int(gemv_wide(xq, q)), plan.grid[1], plan.k_per_split)
    else:
        split = (0, 1, K)
    rc = lib.qmm_a8(xq.data_ptr(), sx.data_ptr(), q.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), M, N, K, bf16, *split,
                    stream)
    _build.check(rc, "qmm_a8_gemv" if gemv else "qmm_a8")
    LAUNCHES["w8a8"] += 1
    LAUNCHES["w8a8_gemv"] += gemv
    return out

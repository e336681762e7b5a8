"""Public kernel entry points (port of ``repro.kernels.ops``).

Model code calls only these.  Each routes by where its tensors lie: a
CUDA tensor goes to the hand-written kernel (which raises on what it does
not take; there is no fallback), a CPU tensor to the kernel's plain
PyTorch version.  Any other device raises.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.quant.ptq import QTensor, quantize_rowwise


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {**_qm.LAUNCHES, **_fd.LAUNCHES}


def reset_launch_counts() -> None:
    for d in (_qm.LAUNCHES, _fd.LAUNCHES):
        for k in d:
            d[k] = 0


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


def fusable_decode(p, cfg) -> bool:
    """Whether a layer's attention can take the fused quantized decode
    kernel (the JAX package's ``flash_decode_fused``).  Always False in the
    port so far: that kernel (K6, and K7 for the paged arena) is still to be
    ported; see ROADMAP.md, Queue 2."""
    return False


def decode_kernel_tier(p, cfg) -> str:
    """Which decode-attention tier a kernel-routed step takes for layer
    params ``p`` under ``cfg``: ``"fused"`` when ``fusable_decode`` holds,
    else ``"flash"``.  The int8 KV cache (``kv_bits == 8``, the JAX
    package's ``"kv8"`` tier) is not ported yet."""
    if cfg.kv_bits == 8:
        raise NotImplementedError("int8 KV cache (kv_bits=8) is not ported "
                                  "yet; see ROADMAP.md")
    return "fused" if fusable_decode(p, cfg) else "flash"


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """GQA decode attention: q (B, nh, dh) against k/v (B, W, nkv, dh);
    slots >= n_valid (int or (B,) int32) are masked."""
    if _on_cuda(q):
        return _fd.flash_decode_cuda(q.contiguous(), k, v, n_valid)
    return _fd.flash_decode_plain(q, k, v, n_valid)

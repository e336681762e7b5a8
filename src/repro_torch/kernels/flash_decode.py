"""One-token GQA decode attention: the CUDA kernel and its plain version.

The kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``_decode_kernel`` of ``repro/kernels/flash_decode.py``.
``flash_decode_cuda`` launches it on CUDA tensors and counts its launches
in ``LAUNCHES``; ``flash_decode_plain`` is the same function in plain
PyTorch (twin of ``repro.kernels.ref.flash_decode_ref``).

q (B, nh, dh) attends over k/v (B, W, nkv, dh); slots >= n_valid (an int
for every row, or a (B,) int32 tensor) are masked.  n_valid must be >= 1.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_decode": 0}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    B, nh, dh = q.shape
    W, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    qf = q.reshape(B, nkv, G, dh).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))   # f32, exact
    logits = torch.einsum("bkgd,bskd->bkgs", qf, kf) * scale
    if not isinstance(n_valid, torch.Tensor):
        n_valid = torch.full((B,), n_valid, device=q.device)
    nv = n_valid.expand(B)
    mask = torch.arange(W, device=q.device)[None, :] < nv[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vf)
    return out.reshape(B, nh, dh).to(q.dtype)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    B, nh, dh = q.shape
    W, nkv = k.shape[1], k.shape[2]
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    for name, t, shape in (("q", q, (B, nh, dh)), ("k", k, (B, W, nkv, dh)),
                           ("v", v, (B, W, nkv, dh))):
        if not t.is_cuda or t.dtype != q.dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA {q.dtype} "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    nv_ptr, nv_scalar = None, 0
    if isinstance(n_valid, torch.Tensor):
        if not n_valid.is_cuda or n_valid.dtype != torch.int32 \
                or tuple(n_valid.shape) != (B,) \
                or not n_valid.is_contiguous():
            raise ValueError("n_valid: need a contiguous CUDA int32 tensor "
                             f"of shape ({B},)")
        nv_ptr = n_valid.data_ptr()
    else:
        nv_scalar = int(n_valid)
    out = torch.empty_like(q)
    lib = _build.library("flash_decode")
    rc = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), nv_ptr,
                          nv_scalar, out.data_ptr(), B, nh, nkv, W, dh,
                          1.0 / dh ** 0.5, int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out

"""One-token GQA decode attention: the CUDA kernels and their plain
versions.

The kernels (``csrc/flash_decode.cu``) replace the Pallas TPU kernels
``_decode_kernel`` (K4, over a slot cache) and ``_paged_decode_kernel``
(K5, through a block table over a page arena) of
``repro/kernels/flash_decode.py``.  ``flash_decode_cuda`` and
``flash_decode_paged_cuda`` launch them on CUDA tensors and count their
launches in ``LAUNCHES``; ``flash_decode_plain`` is the same function in
plain PyTorch (twin of ``repro.kernels.ref.flash_decode_ref``) and
``flash_decode_paged_plain`` gathers the pages into a slab and calls it
(the twin of the JAX package's gather path, which has no paged oracle).

q (B, nh, dh) attends over k/v (B, W, nkv, dh); slots >= n_valid (an int
for every row, or a (B,) int32 tensor) are masked.  n_valid must be >= 1.
Paged: slot j of row b lives in page ``table[b, j // bt]`` at offset
``j % bt`` of k/v pages (P, bt, nkv, dh), W = n_b * bt.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0}


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


def flash_decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, table: torch.Tensor,
                             n_valid: Union[int, torch.Tensor]
                             ) -> torch.Tensor:
    """Gather each row's pages into its (B, n_b * bt, nkv, dh) slab and
    attend over it with ``flash_decode_plain``."""
    B, n_b = table.shape
    bt = k_pages.shape[1]
    idx = table.long()

    def gather(pages):
        g = pages[idx]                           # (B, n_b, bt, nkv, dh)
        return g.reshape((B, n_b * bt) + tuple(g.shape[3:]))

    return flash_decode_plain(q, gather(k_pages), gather(v_pages), n_valid)


def _check_q(q: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    if not q.is_cuda or q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q: need a contiguous CUDA (B, nh, dh) tensor, got "
                         f"{tuple(q.shape)} on {q.device}")


def _n_valid_args(n_valid: Union[int, torch.Tensor], B: int):
    """(device pointer or None, scalar) for the kernels' n_valid."""
    if isinstance(n_valid, torch.Tensor):
        if not n_valid.is_cuda or n_valid.dtype != torch.int32 \
                or tuple(n_valid.shape) != (B,) \
                or not n_valid.is_contiguous():
            raise ValueError("n_valid: need a contiguous CUDA int32 tensor "
                             f"of shape ({B},)")
        return n_valid.data_ptr(), 0
    return None, int(n_valid)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_valid: Union[int, torch.Tensor]) -> torch.Tensor:
    _check_q(q)
    B, nh, dh = q.shape
    W, nkv = k.shape[1], k.shape[2]
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    for name, t, shape in (("k", k, (B, W, nkv, dh)),
                           ("v", v, (B, W, nkv, dh))):
        if not t.is_cuda or t.dtype != q.dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA {q.dtype} "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    nv_ptr, nv_scalar = _n_valid_args(n_valid, B)
    out = torch.empty_like(q)
    lib = _build.library("flash_decode")
    rc = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), nv_ptr,
                          nv_scalar, out.data_ptr(), B, nh, nkv, W, dh,
                          1.0 / dh ** 0.5, int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            n_valid: Union[int, torch.Tensor]
                            ) -> torch.Tensor:
    """K5.  k/v pages (P, bt, nkv, dh) may be strided views (the leading
    corner of a wider page tail); only their d_head axis must be
    contiguous, and k and v must share their strides."""
    _check_q(q)
    B, nh, dh = q.shape
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages: need (P, bt, nkv, dh), got "
                         f"{tuple(k_pages.shape)}")
    P, bt, nkv = k_pages.shape[:3]
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != q.dtype \
                or tuple(t.shape) != (P, bt, nkv, dh) or t.stride(3) != 1 \
                or t.stride() != k_pages.stride():
            raise ValueError(f"{name}: need a CUDA {q.dtype} tensor of shape "
                             f"{(P, bt, nkv, dh)} with a contiguous last "
                             f"axis and k's strides {k_pages.stride()}, got "
                             f"{t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    if not table.is_cuda or table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != B or not table.is_contiguous():
        raise ValueError(f"table: need a contiguous CUDA int32 (B={B}, n_b) "
                         f"tensor, got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    n_b = table.shape[1]
    nv_ptr, nv_scalar = _n_valid_args(n_valid, B)
    out = torch.empty_like(q)
    lib = _build.library("flash_decode")
    ps, ss, hs = k_pages.stride()[:3]
    rc = lib.flash_decode_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), nv_ptr, nv_scalar, out.data_ptr(), B, nh, nkv,
        n_b, bt, dh, ps, ss, hs, 1.0 / dh ** 0.5,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode_paged")
    LAUNCHES["flash_decode_paged"] += 1
    return out

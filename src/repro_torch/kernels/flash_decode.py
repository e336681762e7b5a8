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
One call of K4 or K5 is two launches: one block per (split, kv head, row)
writes float32 partials (m, l, acc) of its ``SPLIT`` logical slots to a
workspace the wrapper allocates, then a merge sums the splits below
n_valid in index order (``split_plan``).  The grid and the workspace
depend only on (B, nh, nkv, W, dh).

q (B, nh, dh) attends over k/v (B, W, nkv, dh); slots >= n_valid (an int
for every row, or a (B,) int32 tensor) are masked.  n_valid must be >= 1.
K4 scales the logits by ``scale`` (None: 1/sqrt(dh), K5's only factor).
Paged: slot j of row b lives in page ``table[b, j // bt]`` at offset
``j % bt`` of k/v pages (P, bt, nkv, dh), W = n_b * bt.

The fused quantized tier (``csrc/flash_decode_fused.cu``) replaces
``_fused_body`` (K6, ``flash_decode_fused``) and ``_fused_paged_body`` (K7,
``flash_decode_fused_paged``): one decode-attention step from the hidden
row x (B, D) and int8 wq/wk/wv/wo with their (1, cols) float32 scales.
It projects q (G heads), k1 and v1 per KV head (a8: the row quantized to
int8 in the kernel, int8 x int8 -> int32), rotates q and k1 by the rope
rows cos/sin (1, dh/2), attends over the PRE-write cache (slots >= n_valid
and the slot ``evict`` are masked; n_valid may be 0), folds the current
token in as the last online-softmax step and pushes each head group
through its wo tile; the per-head partials are summed in head order in
x's type, as the TPU grid accumulates its output block.  It returns
(o (B, D), k1, v1 (B, nkv, dh)); the caller writes k1/v1.  The kernel
reads each weight byte once for up to ``FU_ROWS`` rows of x (one launch
per group of them): one cluster of blocks per KV head, cut by
``fused_plan`` from the shapes alone, so a row's results are bitwise the
same alone and in a batch.
``flash_decode_fused_plain`` / ``flash_decode_fused_paged_plain`` are the
same functions in plain PyTorch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import a8_accumulate_plain
from repro_torch.quant.ptq import _INV_INT8_MAX, quantize_rowwise

NEG = -1e30

LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0,
            "flash_decode_fused": 0, "flash_decode_fused_paged": 0}

# logical slots of one split of K4/K5: ``SPLIT`` of csrc/flash_decode.cu,
# which the CPU tests hold equal to this one
SPLIT = 64


def split_plan(W: int):
    """The splits K4/K5 cut a row's W slots into: [start, stop) ranges of
    ``SPLIT`` logical slots (the last one cut at W), in the order the merge
    sums them.  The kernels launch one block per split and size their
    workspace by it; a split at or past a row's n_valid does nothing."""
    return [(s, min(s + SPLIT, W)) for s in range(0, W, SPLIT)]


# constants of csrc/flash_decode_fused.cu, which the CPU tests hold equal
FU_ROWS = 8             # FU_ROWS, rows of x one launch takes
FU_KSTEP = 16           # FU_KSTEP, k rows of a warp step
FU_BN = 128             # FU_BN, columns of a warp tile
FU_WARPS = 8            # FU_WARPS, warps of a block
FU_BS = 64              # FU_BS, cache slots of an attention tile
FU_MAX_CLUSTER = 8      # FU_MAX_CLUSTER, blocks of a cluster
_FUSED_TARGET_BLOCKS = 132      # the H100's SMs


class FusedPlan(NamedTuple):
    """How K6/K7 cut one call's work (``fused_plan``)."""
    cluster: int                           # blocks of one KV head's cluster
    k_per_block: int                       # D rows a block projects q/k/v over
    wo_per_block: int                      # wo columns a block takes
    k_splits: Tuple[Tuple[int, int], ...]  # [start, stop) of D, by block
    wo_splits: Tuple[Tuple[int, int], ...]  # [start, stop) of wo's columns
    rows: Tuple[Tuple[int, ...], ...]      # rows of a group of FU_ROWS, by block
    slot_tile: int                         # cache slots of a tile, in order
    merge_order: Tuple[int, ...]           # blocks whose q/k/v sums are added


@lru_cache(maxsize=None)
def fused_plan(D: int, nkv: int, G: int, dh: int) -> FusedPlan:
    """The partition of K6/K7, from the shapes alone (never B or values).

    One cluster of ``cluster`` blocks per KV head: the largest power of two
    up to ``FU_MAX_CLUSTER`` that keeps nkv * cluster within the card's 132
    SMs (4 at BLOOM-7B1's nkv = 32).  Block r projects q/k/v (the head's
    (G + 2) * dh columns) over D rows ``k_splits[r]`` for every row of x,
    attends the rows ``rows[r]`` of each group of ``FU_ROWS`` (r, r +
    cluster, ...) over tiles of ``slot_tile`` slots in index order, and
    takes wo columns ``wo_splits[r]`` of the head's G * dh rows.  The q/k/v
    sums of a row are added over the blocks in ``merge_order``, within a
    block over its warps in warp order; the heads' partials in head order.
    A block's D rows and wo columns are whole warp steps (16)."""
    C = 1
    while 2 * C <= FU_MAX_CLUSTER and 2 * C * nkv <= _FUSED_TARGET_BLOCKS:
        C *= 2
    per = -(-(-(-D // C)) // FU_KSTEP) * FU_KSTEP
    splits = tuple((min(D, r * per), min(D, (r + 1) * per)) for r in range(C))
    return FusedPlan(C, per, per, splits, splits,
                     tuple(tuple(range(r, FU_ROWS, C)) for r in range(C)),
                     FU_BS, tuple(range(C)))


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_valid: Union[int, torch.Tensor],
                       scale: Optional[float] = None) -> torch.Tensor:
    B, nh, dh = q.shape
    W, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    qf = q.reshape(B, nkv, G, dh).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))  # f32, exact
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
    return flash_decode_plain(q, gather_pages(k_pages, table),
                              gather_pages(v_pages, table), n_valid)


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each row's logical blocks of pages (P, bt, ...) through table
    (B, n_b), as one contiguous (B, n_b * bt, ...) slab."""
    B, n_b = table.shape
    g = pages[table.long()]                      # (B, n_b, bt, ...)
    return g.reshape((B, n_b * pages.shape[1]) + tuple(g.shape[3:]))


def _qproject_plain(xr: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                    a8: bool) -> torch.Tensor:
    """(..., R, Din) float32 @ dequant(w (..., Din, Dout) int8, s) ->
    (..., R, Dout) float32, batched over the leading axes.  a16: the weight
    is dequantized (``w * s``) and then dotted; a8: each row is quantized
    (absmax * float32(1/127), round half to even, clip), summed exactly in
    int32 and rescaled once, ``acc * sx * s``."""
    s = s.reshape(-1).to(torch.float32)
    if a8:
        xq, sx = quantize_rowwise(xr)
        return a8_accumulate_plain(xq, w).to(torch.float32) * sx * s
    return xr @ (w.to(torch.float32) * s)


def _rot_half(t: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Split-halves rope on the last axis; cos/sin (1, dh/2)."""
    t1, t2 = torch.chunk(t, 2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)


def _per_row(v: Union[int, torch.Tensor], B: int,
             device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.reshape(-1).expand(B)
    return torch.full((B,), int(v), dtype=torch.int32, device=device)


def flash_decode_fused_plain(x, wq, sq, wk, sk, wv, sv, wo, so, k_cache,
                             v_cache, n_valid, evict, cos, sin,
                             use_rope: bool = True, a8: bool = False):
    """K6 in plain PyTorch.  x (B, D); wq (D, nh*dh), wk/wv (D, nkv*dh),
    wo (nh*dh, D) int8 with float32 scales of one value per column; k/v
    cache (B, W, nkv, dh) PRE-write; n_valid / evict an int or a (B,)
    tensor (evict -1: no slot is evicted); cos/sin (1, dh/2) float32.
    Returns (o (B, D), k1, v1 (B, nkv, dh)), all in x's type."""
    B, D = x.shape
    W, nkv, dh = k_cache.shape[1:]
    G = wq.shape[1] // dh // nkv
    xr = x.to(torch.float32)
    q = _qproject_plain(xr, wq, sq, a8).reshape(B, nkv, G, dh)
    k1 = _qproject_plain(xr, wk, sk, a8).reshape(B, nkv, dh)
    v1 = _qproject_plain(xr, wv, sv, a8).reshape(B, nkv, dh)
    if use_rope:
        q = _rot_half(q, cos, sin)
        k1 = _rot_half(k1, cos, sin)
    qs = q * float(np.float32(1.0 / dh ** 0.5))
    # online softmax over the pre-write cache: one block of W slots
    s = torch.einsum("bkgd,bskd->bkgs", qs, k_cache.to(torch.float32))
    slot = torch.arange(W, device=x.device)[None, :]
    valid = (slot < _per_row(n_valid, B, x.device)[:, None]) \
        & (slot != _per_row(evict, B, x.device)[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    # the current token, the last step
    s_cur = (qs * k1[:, :, None, :]).sum(-1, keepdim=True)
    m_fin = torch.maximum(m, s_cur)
    p_cur = torch.exp(s_cur - m_fin)
    alpha = torch.exp(m - m_fin)
    l_fin = alpha * l + p_cur
    acc = acc * alpha + p_cur * v1[:, :, None, :]
    attn = (acc / torch.clamp(l_fin, min=1e-30)).reshape(B, nkv, G * dh)
    # each head group through its wo tile (a8: rows of G * dh), summed in
    # head order in x's type
    parts = _qproject_plain(attn.transpose(0, 1),
                            wo.reshape(nkv, G * dh, D), so, a8)
    o = parts[0].to(x.dtype)
    for h in range(1, nkv):
        o = o + parts[h].to(x.dtype)
    return o, k1.to(x.dtype), v1.to(x.dtype)


def flash_decode_fused_paged_plain(x, wq, sq, wk, sk, wv, sv, wo, so,
                                   k_pages, v_pages, table, n_valid, evict,
                                   cos, sin, use_rope: bool = True,
                                   a8: bool = False):
    """K7 in plain PyTorch: K6 on each row's pages (P, bt, nkv, dh),
    gathered through table (B, n_b) into the (B, n_b * bt, nkv, dh) slab."""
    return flash_decode_fused_plain(
        x, wq, sq, wk, sk, wv, sv, wo, so, gather_pages(k_pages, table),
        gather_pages(v_pages, table), n_valid, evict, cos, sin, use_rope, a8)


def _check_q(q: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    if not q.is_cuda or q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q: need a contiguous CUDA (B, nh, dh) tensor, got "
                         f"{tuple(q.shape)} on {q.device}")


def _scalar_or_ptr(v: Union[int, torch.Tensor], B: int, name: str):
    """(device pointer or None, scalar) for a per-row int argument of the
    kernels (n_valid, evict): an int for every row, or a (B,) tensor."""
    if isinstance(v, torch.Tensor):
        if not v.is_cuda or v.dtype != torch.int32 \
                or tuple(v.shape) != (B,) or not v.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA int32 tensor "
                             f"of shape ({B},)")
        return v.data_ptr(), 0
    return None, int(v)


def _workspace(q: torch.Tensor, W: int) -> torch.Tensor:
    """Float32 scratch for the split partials: (B, nh, splits, dh) sums,
    then (B, nh, splits, 2) running max and denominator, one split for
    each entry of ``split_plan(W)``."""
    B, nh, dh = q.shape
    return torch.empty(B * nh * -(-W // SPLIT) * (dh + 2),
                       dtype=torch.float32, device=q.device)


def _wide(dh: int, tensors, strides, elt: int) -> int:
    """1 where every K/V row can be read in 16-byte pieces: d_head a
    multiple of 8 (the kernels' chunk), 16-byte aligned bases and strides.
    Otherwise the same kernel reads element by element; the sums are the
    same either way."""
    return int(dh % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
               and all(s * elt % 16 == 0 for s in strides))


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_valid: Union[int, torch.Tensor],
                      scale: Optional[float] = None) -> torch.Tensor:
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
    nv_ptr, nv_scalar = _scalar_or_ptr(n_valid, B, "n_valid")
    out = torch.empty_like(q)
    ws = _workspace(q, W)
    lib = _build.library("flash_decode")
    rc = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), nv_ptr,
                          nv_scalar, out.data_ptr(), ws.data_ptr(), B, nh,
                          nkv, W, dh,
                          1.0 / dh ** 0.5 if scale is None else scale,
                          int(q.dtype == torch.bfloat16),
                          _wide(dh, (k, v), (dh,), q.element_size()),
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
    nv_ptr, nv_scalar = _scalar_or_ptr(n_valid, B, "n_valid")
    out = torch.empty_like(q)
    ws = _workspace(q, n_b * bt)
    lib = _build.library("flash_decode")
    ps, ss, hs = k_pages.stride()[:3]
    rc = lib.flash_decode_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), nv_ptr, nv_scalar, out.data_ptr(), ws.data_ptr(),
        B, nh, nkv, n_b, bt, dh, ps, ss, hs, 1.0 / dh ** 0.5,
        int(q.dtype == torch.bfloat16),
        _wide(dh, (k_pages, v_pages), (ps, ss, hs), q.element_size()),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode_paged")
    LAUNCHES["flash_decode_paged"] += 1
    return out


def _fused_args(x, wq, sq, wk, sk, wv, sv, wo, so, nkv, dh, cos, sin,
                n_valid, evict):
    """Check the fused kernels' common operands; return the pointer and
    size arguments they share, and the scratch and output tensors."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    if not x.is_cuda or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous CUDA (B, D) tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    B, D = x.shape
    if dh % 2 or D % 2:
        raise ValueError(f"d_head={dh} and d_model={D} must be even")
    nh = wq.shape[-1] // dh
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    for name, w, shape in (("wq", wq, (D, nh * dh)), ("wk", wk, (D, nkv * dh)),
                           ("wv", wv, (D, nkv * dh)), ("wo", wo, (nh * dh, D))):
        if not w.is_cuda or w.dtype != torch.int8 or tuple(w.shape) != shape \
                or not w.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA int8 tensor of "
                             f"shape {shape}, got {w.dtype} "
                             f"{tuple(w.shape)} on {w.device}")
    for name, s, n in (("sq", sq, nh * dh), ("sk", sk, nkv * dh),
                       ("sv", sv, nkv * dh), ("so", so, D)):
        if not s.is_cuda or s.dtype != torch.float32 or s.numel() != n \
                or not s.is_contiguous():
            raise ValueError(f"{name}: need {n} contiguous CUDA float32 "
                             f"scales, got {s.dtype} {tuple(s.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if not t.is_cuda or t.dtype != torch.float32 \
                or t.numel() != dh // 2 or not t.is_contiguous():
            raise ValueError(f"{name}: need {dh // 2} contiguous CUDA "
                             f"float32 values, got {tuple(t.shape)}")
    mma = int(dh % 16 == 0 and D % 16 == 0
              and all(w.data_ptr() % 16 == 0 for w in (wq, wk, wv, wo)))
    nv_ptr, nv_scalar = _scalar_or_ptr(n_valid, B, "n_valid")
    ev_ptr, ev_scalar = _scalar_or_ptr(evict, B, "evict")
    out = torch.empty_like(x)
    k1 = torch.empty((B, nkv, dh), dtype=x.dtype, device=x.device)
    v1 = torch.empty_like(k1)
    part = torch.empty((B, nkv, D), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, wq, sq, wk, sk, wv, sv, wo, so)]
    return (B, D, nh, mma, ptrs, (nv_ptr, nv_scalar, ev_ptr, ev_scalar),
            (cos.data_ptr(), sin.data_ptr(), out.data_ptr(), k1.data_ptr(),
             v1.data_ptr(), part.data_ptr()), (out, k1, v1))


def flash_decode_fused_cuda(x, wq, sq, wk, sk, wv, sv, wo, so, k_cache,
                            v_cache, n_valid, evict, cos, sin,
                            use_rope: bool = True, a8: bool = False):
    """K6: ``flash_decode_fused_plain``'s function on CUDA tensors (one
    call launches the fused kernel once per group of ``FU_ROWS`` rows, then
    the fixed-order head sum)."""
    nkv, dh = k_cache.shape[2], k_cache.shape[3]
    B, D, nh, mma, ptrs, ints, outs, res = _fused_args(
        x, wq, sq, wk, sk, wv, sv, wo, so, nkv, dh, cos, sin, n_valid, evict)
    W = k_cache.shape[1]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_cuda or t.dtype != x.dtype \
                or tuple(t.shape) != (B, W, nkv, dh) or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA {x.dtype} "
                             f"tensor of shape {(B, W, nkv, dh)}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    plan = fused_plan(D, nkv, nh // nkv, dh)
    lib = _build.library("flash_decode_fused")
    rc = lib.flash_decode_fused(
        *ptrs, k_cache.data_ptr(), v_cache.data_ptr(), *ints, *outs, B, D, nh,
        nkv, dh, W, 1.0 / dh ** 0.5, _INV_INT8_MAX, int(use_rope), int(a8),
        int(x.dtype == torch.bfloat16), mma,
        _wide(dh, (k_cache, v_cache), (dh,), x.element_size()),
        plan.cluster, plan.k_per_block, plan.wo_per_block,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "flash_decode_fused")
    LAUNCHES["flash_decode_fused"] += 1
    return res


def flash_decode_fused_paged_cuda(x, wq, sq, wk, sk, wv, sv, wo, so,
                                  k_pages, v_pages, table, n_valid, evict,
                                  cos, sin, use_rope: bool = True,
                                  a8: bool = False):
    """K7: K6 through a block table.  k/v pages (P, bt, nkv, dh) may be
    strided views (the leading corner of a wider page tail); only their
    d_head axis must be contiguous, and k and v must share their
    strides."""
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages: need (P, bt, nkv, dh), got "
                         f"{tuple(k_pages.shape)}")
    P, bt, nkv, dh = k_pages.shape
    B, D, nh, mma, ptrs, ints, outs, res = _fused_args(
        x, wq, sq, wk, sk, wv, sv, wo, so, nkv, dh, cos, sin, n_valid, evict)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != x.dtype \
                or tuple(t.shape) != (P, bt, nkv, dh) or t.stride(3) != 1 \
                or t.stride() != k_pages.stride():
            raise ValueError(f"{name}: need a CUDA {x.dtype} tensor of shape "
                             f"{(P, bt, nkv, dh)} with a contiguous last "
                             f"axis and k's strides {k_pages.stride()}, got "
                             f"{t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}")
    if not table.is_cuda or table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != B or not table.is_contiguous():
        raise ValueError(f"table: need a contiguous CUDA int32 (B={B}, n_b) "
                         f"tensor, got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    plan = fused_plan(D, nkv, nh // nkv, dh)
    lib = _build.library("flash_decode_fused")
    ps, ss, hs = k_pages.stride()[:3]
    rc = lib.flash_decode_fused_paged(
        *ptrs, k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        *ints, *outs, B, D, nh, nkv, dh, table.shape[1], bt, ps, ss, hs,
        1.0 / dh ** 0.5, _INV_INT8_MAX, int(use_rope), int(a8),
        int(x.dtype == torch.bfloat16), mma,
        _wide(dh, (k_pages, v_pages), (ps, ss, hs), x.element_size()),
        plan.cluster, plan.k_per_block, plan.wo_per_block,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "flash_decode_fused_paged")
    LAUNCHES["flash_decode_fused_paged"] += 1
    return res

"""Post-training quantization in PyTorch (port of ``repro.quant.ptq``).

Per-channel symmetric round-to-nearest weight quantization along the
reduction axis (-2), scales per output channel (-1):

  w[..., :, j]  ~=  q[..., :, j] * scale[..., 0, j],
  q int8 (8-bit) or int4 (packed two-rows-per-int8 along -2),
  scale = max|w| / qmax  over axis -2 (keepdims).

The integer results (q, packed q, scales) are bitwise those of the JAX
package on the same float32 weights: ``torch.round`` rounds half to even
like ``jnp.round``, and the nibble packing and sign extension are done in
int32, where torch's and XLA's shift semantics agree.

Parameter trees here are nested dicts and lists of tensors (the port
keeps one dict per layer in a list, not a layer-stacked axis); quantizing
per layer gives the same values as quantizing the stacked tensor, since
the scale is taken over axis -2 only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

Params = Any

INT4_MAX = 7
INT8_MAX = 127
_INV_INT8_MAX = float(np.float32(1.0 / INT8_MAX))


@dataclass
class QTensor:
    """Per-channel symmetric quantized weight.

    q: int8 carrier, same shape as the source except axis -2 is halved for
    bits=4 (two nibbles per int8: row 2i -> low, row 2i+1 -> high);
    scale: (..., 1, N) float32.  ``shape``/``dtype`` describe the logical
    dequantized tensor.  ``act_bits`` is the activation precision the
    weight is consumed at (16 = fp activations, 8 = dynamic per-row int8,
    the W8A8 kernel tier).
    """
    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    act_bits: int = 16
    _dense: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def dense(self) -> torch.Tensor:
        """The dequantized tensor, made once and kept: the embedding
        gather and the tied unembedding read it every decode step (see
        ``models.transformer``), and dequantizing anew each time would
        move three times its bytes."""
        if self._dense is None:
            self._dense = dequantize(self)
        return self._dense


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, [-8,7]) pairwise along axis -2.
    Rows must be even: row 2i -> low nibble, row 2i+1 -> high nibble."""
    lo = q[..., 0::2, :].to(torch.int32) & 0x0F
    hi = (q[..., 1::2, :].to(torch.int32) & 0x0F) << 4
    byte = lo | hi                                    # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: (..., R/2, C) int8 -> (..., R, C) in [-8, 7].

    Even rows take the low nibble sign-extended (``(x << 4) >> 4`` on
    int8 in the JAX package), odd rows the high nibble (``x >> 4``,
    arithmetic).  Computed on the sign-extended int32 value, which gives
    the same bits."""
    x = packed.to(torch.int32)
    lo = ((x & 0x0F) ^ 0x08) - 0x08
    hi = x >> 4
    out = torch.stack([lo, hi], dim=-2)               # (..., R/2, 2, C)
    shape = packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1])
    return out.reshape(shape).to(torch.int8)


def quantize(w: torch.Tensor, bits: int = 8, act_bits: int = 16) -> QTensor:
    """Per-output-channel symmetric RTN quantization (reduction axis -2)."""
    assert bits in (4, 8), bits
    assert act_bits in (8, 16), act_bits
    assert w.ndim >= 2, w.shape
    wf = w.to(torch.float32)
    qmax = INT4_MAX if bits == 4 else INT8_MAX
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        if q.shape[-2] % 2:
            pad = torch.zeros(q.shape[:-2] + (1, q.shape[-1]),
                              dtype=q.dtype, device=q.device)
            q = torch.cat([q, pad], dim=-2)
        q = pack_int4(q)
    return QTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape),
                   dtype=w.dtype, act_bits=act_bits)


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric activation quantization (absmax / 127).

    x (..., K) -> (int8 values (..., K), f32 scales (..., 1)).  The scale
    is ``absmax * float32(1/127)``, a multiply and not a divide, as in the
    JAX package: its kernel/oracle pair relies on bitwise-equal scales."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a Python float holding float32(1/127) exactly: no host-to-device copy
    scale = torch.where(absmax > 0, absmax * _INV_INT8_MAX,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale),
                    -INT8_MAX - 1, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize(t: QTensor) -> torch.Tensor:
    q = t.q
    if t.bits == 4:
        q = unpack_int4(q)[..., :t.shape[-2], :]
    w = q.to(torch.float32) * t.scale
    return w.to(t.dtype)


def _is_weight(leaf: Any) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.is_floating_point())


# Param names that are true matmul weights consumed through common.mm() /
# maybe_dequant() — the same set as the JAX package's.
MATMUL_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "router", "lm_head", "embed",
})


def _tree_map(fn, tree, key=None):
    """Map ``fn(key, leaf)`` over a tree of dicts and lists; ``key`` is
    the dict key a leaf sits under (list items inherit their parent's)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, key) for v in tree)
    return fn(key, tree)


def tree_leaves(tree):
    out = []
    _tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def quantize_tree(params: Params, bits: int = 8,
                  keys: frozenset = MATMUL_KEYS,
                  act_bits: int = 16) -> Params:
    """Quantize the named matmul leaves; keep everything else fp.
    ``act_bits=8`` tags every quantized leaf for the W8A8 tier; the
    weights themselves are identical to ``act_bits=16``."""
    def maybe(key, w):
        if key in keys and _is_weight(w):
            return quantize(w, bits, act_bits=act_bits)
        return w
    return _tree_map(maybe, params)


def with_act_bits(params: Params, act_bits: int) -> Params:
    """A quantized tree tagged for other activation bits: each QTensor is a
    new one over the same q, scale and kept dequantized tensor (``dense``),
    and every other leaf is the same tensor.  It equals ``quantize_tree``
    of the source weights at ``act_bits``, whose weights do not depend on
    the tag, and holds no second copy of them."""
    assert act_bits in (8, 16), act_bits
    return _tree_map(
        lambda _, l: QTensor(l.q, l.scale, l.bits, l.shape, l.dtype,
                             act_bits=act_bits, _dense=l._dense)
        if isinstance(l, QTensor) else l, params)


def dequantize_tree(params: Params) -> Params:
    return _tree_map(
        lambda _, l: dequantize(l) if isinstance(l, QTensor) else l, params)


def tree_bytes(params: Params) -> int:
    """Total parameter bytes of a (possibly quantized) tree."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total

"""Parameters, caches (and paged-arena contents) of the JAX package, as the
port's.

The JAX package stacks every layer leaf along one or two leading axes (it
scans over layers); the port keeps lists of per-layer dicts.
``from_jax_params`` takes that tree handed over as numpy arrays
(``jax.device_get(params)``; bfloat16 arrays come through as ml_dtypes'
bfloat16 and are reinterpreted, not converted) and slices each stacked
leaf into the port's lists, whatever its rank (an MoE layer's (L, E, D,
F) expert weights become (E, D, F), qk-norm's (L, dh) scales (dh,)):

- transformer family: ``layers`` (L, ...) -> L dicts;
- zamba2 (hybrid): ``main`` (G, K, ...) -> G * K dicts, group-major, and
  ``tail`` (T, ...) -> T dicts; ``shared`` is one set;
- xLSTM (ssm): ``mlstm`` (G, M, ...) -> G * M dicts, group-major,
  ``slstm`` (G, ...) and ``tail`` (T, ...);
- Whisper (audio): ``enc_layers`` / ``dec_layers`` (L, ...).

A quantized JAX tree (its ``QTensor`` leaves, q (..., K, N) and scale
(..., 1, N)) is sliced the same way into the port's ``QTensor``; the JAX
package quantizes over axis -2 only, so a layer's slice is the port's own
quantization of that layer, bit for bit.  ``cache_from_jax`` does the same
for a decode cache; a gradient tree goes through ``from_jax_params`` and
an AdamW state through ``opt_state_from_jax``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.api import STACKED
from repro_torch.quant.ptq import QTensor
from repro_torch.serving.engine import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}



def to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve_device(device))


def _is_qtensor(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("q", "scale", "bits", "act_bits"))


def _convert(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device) for v in tree)
    if _is_qtensor(tree):
        return QTensor(q=to_tensor(tree.q, device),
                       scale=to_tensor(tree.scale, device), bits=tree.bits,
                       shape=tuple(tree.shape),
                       dtype=_DTYPES[np.dtype(tree.dtype).name],
                       act_bits=tree.act_bits)
    return to_tensor(tree, device)


def _layer(tree, i):
    """Leaf-wise slice ``[i]`` of a layer-stacked subtree (a quantized
    leaf's q and scale alike)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_layer(v, i) for v in tree)
    if _is_qtensor(tree):
        return type(tree)(tree.q[i], tree.scale[i], tree.bits,
                          tuple(tree.shape)[1:], tree.dtype, tree.act_bits)
    return tree[i]


def _leaf(tree):
    while isinstance(tree, (dict, tuple, list)):
        tree = next(v for v in (tree.values() if isinstance(tree, dict)
                                else tree) if v is not None)
    return tree.q if _is_qtensor(tree) else tree


def _unstack(tree, n_axes: int) -> list:
    """A subtree stacked on ``n_axes`` leading axes as the list of its
    per-layer subtrees, row-major."""
    out = [tree]
    for _ in range(n_axes):
        out = [_layer(t, i) for t in out
               for i in range(np.shape(_leaf(t))[0])]
    return out


def from_jax_params(params: Any, device="cuda") -> Any:
    """Port tree from a JAX param tree of numpy arrays, of any family, on
    ``device`` (a CUDA device must exist; pass "cpu" for the CPU).  The
    stacked leaves' leading axes give the layer counts."""
    out = {}
    for k, v in params.items():
        if k in STACKED:
            out[k] = [_convert(t, device) for t in _unstack(v, STACKED[k])]
        else:
            out[k] = _convert(v, device)
    return out


def opt_state_from_jax(opt: Any, device="cuda"):
    """The port's ``AdamWState`` from the JAX package's AdamW state handed
    over as numpy arrays (``jax.device_get(opt)``): ``step`` a scalar, and
    ``mu`` and ``nu`` param-shaped trees, unstacked as
    ``from_jax_params`` unstacks the params (so a gradient tree bridges the
    same way).  Resumes the port from the reference's state."""
    from repro_torch.train.optimizer import AdamWState
    step, mu, nu = opt
    return AdamWState(step=to_tensor(np.asarray(step, np.int32), device),
                      mu=from_jax_params(mu, device),
                      nu=from_jax_params(nu, device))


def cache_from_jax(cfg, cache: Any, device="cuda") -> list:
    """The port's per-layer decode cache (a list of dicts, batch on axis 0)
    from a JAX cache of numpy arrays (``jax.device_get(cache)``), in the
    port's execution order:

    - transformer: {"k", "v"[, "ks", "vs"]} (L, B, ...) -> L dicts;
    - zamba2: each group's K {"ssm", "conv"} from ``main_ssm`` /
      ``main_conv`` (G, K, B, ...), then its {"k", "v"} from ``attn_k`` /
      ``attn_v`` (G, B, ...); then the tail's from ``tail_ssm`` /
      ``tail_conv``;
    - xLSTM: each group's M {"C", "n", "m", "conv"} from ``mlstm`` (G, M,
      B, ...), then its {"c", "n", "h", "m"} from the ``slstm`` tuple (G,
      B, ...); then ``tail``'s;
    - Whisper: {"k", "v", "xk", "xv"} (L, B, ...) -> L dicts."""
    def layers(leaves: dict, n_axes: int) -> list:
        return [_convert(t, device) for t in _unstack(leaves, n_axes)]

    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        return layers(dict(cache), 1)
    if fam == "hybrid":
        K = cfg.hybrid.attn_every
        main = layers({"ssm": cache["main_ssm"], "conv": cache["main_conv"]},
                      2)
        attn = layers({"k": cache["attn_k"], "v": cache["attn_v"]}, 1)
        out = []
        for g, site in enumerate(attn):
            out += main[g * K:(g + 1) * K] + [site]
        if "tail_ssm" in cache:
            out += layers({"ssm": cache["tail_ssm"],
                           "conv": cache["tail_conv"]}, 1)
        return out
    if fam == "ssm":
        M = cfg.xlstm.slstm_every - 1
        out = []
        if "mlstm" in cache:
            m = layers(dict(cache["mlstm"]), 2)
            s = layers(dict(zip(("c", "n", "h", "m"), cache["slstm"])), 1)
            for g, st in enumerate(s):
                out += m[g * M:(g + 1) * M] + [st]
        if "tail" in cache:
            out += layers(dict(cache["tail"]), 1)
        return out
    raise ValueError(f"no cache bridge for family {fam!r}")


def to_device(params: Any, device) -> Any:
    """A copy of a port param tree (dicts, lists, tensors, None) on
    ``device``; float trees only (quantize after the move)."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return None if params is None else params.to(device)


def arena_pages_from_jax(arena, pages: Any) -> None:
    """Copy a JAX arena's page buffers, handed over as numpy arrays
    (``jax.device_get(jax_arena.buffers())``: ``{name: (L, P, bt, nkv',
    dh')}``), into the port's ``KVArena`` ``arena`` (same leaves and
    shapes), in place."""
    bufs = arena.buffers()
    if set(bufs) != set(pages):
        raise ValueError(f"leaves {sorted(pages)} != the arena's "
                         f"{sorted(bufs)}")
    for name, buf in bufs.items():
        src = to_tensor(pages[name], buf.device)
        if tuple(src.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != the "
                             f"arena's {tuple(buf.shape)}")
        buf.copy_(src)

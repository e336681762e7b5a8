"""Parameters (and paged-arena contents) of the JAX package, as the port's.

The JAX package's transformer family (dense, MoE, VLM) keeps its params
as nested dicts with every layer leaf stacked on axis 0 (it scans over
layers); the port keeps a list of per-layer dicts.  Slicing ``[i]`` takes
each leaf of layer i, whatever its rank: an MoE layer's (L, E, D, F)
expert weights become (E, D, F), its router (L, D, E) becomes (D, E), and
qk-norm's (L, dh) scales become (dh,).  ``from_jax_params`` takes that tree handed
over as numpy arrays (``jax.device_get(params)``; bfloat16 arrays come
through as ml_dtypes' bfloat16 and are reinterpreted, not converted) and
returns the port's tree on ``device``.  Quantized trees are not bridged:
the port quantizes the bridged float tree with its own ``quant.ptq``,
which gives the JAX package's integers bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.serving.engine import resolve_device


def to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve_device(device))


def _convert(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def _layer(tree, i):
    """Leaf-wise slice ``[i]`` of a layer-stacked subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def from_jax_params(params: Any, n_layers: int, device="cuda") -> Any:
    """Port tree from a JAX transformer param tree of numpy arrays,
    on ``device`` (a CUDA device must exist; pass "cpu" for the CPU)."""
    out = {k: _convert(v, device) for k, v in params.items() if k != "layers"}
    out["layers"] = [_convert(_layer(params["layers"], i), device)
                     for i in range(n_layers)]
    return out


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

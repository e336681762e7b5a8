"""Flat-npz checkpointing for the port's param and optimizer trees (port
of ``repro.train.checkpoint``, in its layout: one array ``leaf_{i}`` per
leaf, in the tree's flatten order; bfloat16 is stored as float32, which
npz can hold)."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _to_np(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if t.dtype == torch.bfloat16:       # npz has no bf16: store f32
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` through a temporary file and
    ``os.replace``, so a reader never sees a half-written file."""
    arrays = {f"leaf_{i}": _to_np(leaf)
              for i, leaf in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``like``.  Raises
    ``AssertionError`` where a stored leaf's shape differs from ``like``'s
    (raised explicitly: it holds under ``python -O``)."""
    leaves = tree_leaves(like)
    loaded = []
    with np.load(path) as data:
        for i, want in enumerate(leaves):
            got = data[f"leaf_{i}"]
            if tuple(got.shape) != tuple(want.shape):
                raise AssertionError(f"leaf_{i}: stored shape {got.shape} "
                                     f"!= {tuple(want.shape)}")
            loaded.append(torch.from_numpy(got).to(device=want.device,
                                                   dtype=want.dtype))
    return tree_unflatten(like, loaded)

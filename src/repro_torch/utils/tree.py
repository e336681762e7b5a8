"""Leaves of the port's param and optimizer trees: dicts (in sorted key
order, as ``jax.tree_util`` orders them), lists, tuples and NamedTuples
of tensors; ``None`` holds no leaf."""
from __future__ import annotations

from typing import Any, Callable, List


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in flatten
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}           # keep the key order
        if isinstance(t, (list, tuple)):
            kids = [build(v) for v in t]
            return type(t)(*kids) if hasattr(t, "_fields") else type(t)(kids)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*args) for args in zip(*cols)])

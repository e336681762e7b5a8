"""Remat (activation-checkpoint) policy, installed by launchers (port of
``repro.utils.remat``).

Models wrap their per-layer sequence bodies in :func:`maybe_remat`.
Without an installed policy this is the identity (tests, serving).
Training launchers install ``remat_scan()`` so each layer's activations
(including the S x S attention intermediates) are recomputed in backward
instead of saved.  A wrapped body runs through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which
saves the body's inputs and recomputes the rest when backward needs it;
the recompute gives the same values, so the gradients are the same.  A
body that calls a callback (a prefill's ``on_kv``, ``on_state``,
``on_layer``) is never wrapped: the recompute would call it twice.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

from torch.utils.checkpoint import checkpoint

_state = threading.local()


def remat_enabled() -> bool:
    return getattr(_state, "on", False)


@contextlib.contextmanager
def remat_scan(on: bool = True):
    prev = remat_enabled()
    _state.on = on
    try:
        yield
    finally:
        _state.on = prev


def maybe_remat(body: Callable) -> Callable:
    """Checkpoint ``body`` when the policy is active (checked when the
    model builds its pass, as the JAX package checks at trace time)."""
    if remat_enabled():
        return functools.partial(checkpoint, body, use_reentrant=False)
    return body

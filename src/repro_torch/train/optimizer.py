"""AdamW over the port's param trees (port of ``repro.train.optimizer``).

Plain functions over trees of tensors (dicts, lists), as the rest of the
port is.  Moments are float32 whatever the param dtype (bf16-safe); the
gradient is clipped to a global norm; bias corrections, the update and the
decoupled weight decay (added to the step before the learning rate
multiplies it) are computed in float32 and the result is cast back to the
param dtype.  ``torch.optim.AdamW`` is not this function: it keeps its
moments in the param dtype, decays every leaf and has no global clip.

Decay falls on the leaves whose JAX-package counterpart has ``ndim >= 2``
(``decay_flags``).  The JAX package stacks every layer's leaves on leading
layer axes (``models.api.STACKED``), so besides the matrices it decays the
per-layer vectors (norm scales, qk-norm, biases, xLSTM's gate biases,
Mamba2's A_log, D and dt_bias) and leaves only the unstacked vectors
(``final_norm``, Whisper's ``enc_norm``, Zamba2's shared block) undecayed,
though its comment says "decay matrices only".  The port decays the same
leaves, so that both train the same function (ROADMAP, Queue 3, F7).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch.models.api import STACKED
from repro_torch.utils.tree import tree_leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    mu: Params
    nu: Params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Params) -> AdamWState:
    """Step 0 and float32 zero moments shaped like ``params``, on their
    devices."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (float32)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    t = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def decay_flags(params: Params) -> List[bool]:
    """Whether AdamW decays each leaf of ``params`` (flatten order): where
    the leaf's rank plus the layer axes the JAX package stacks its layer
    list on (``STACKED``) is at least 2, as the JAX package's
    ``p.ndim >= 2`` reads its stacked leaf."""
    flags: List[bool] = []

    def walk(t, axes):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], axes + (STACKED.get(k, 0)
                                   if isinstance(t[k], list) else 0))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, axes)
        else:
            flags.append(t.ndim + axes >= 2)

    walk(params, 0)
    return flags


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}).

    The update runs in place: the param and moment tensors of ``params``
    and ``state`` are overwritten and returned (the same tensors; only
    ``step`` is new), so a step holds one leaf's float32 temporaries at a
    time, not a second copy of the params and moments."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for p, g, mu, nu, decay in zip(*(tree_leaves(t) for t in
                                     (params, grads, state.mu, state.nu)),
                                   decay_flags(params)):
        # the JAX package's float32 operations in its order, in place
        g = g.to(torch.float32) * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / b1c).div_(torch.sqrt(nu / b2c).add_(cfg.eps))
        p32 = p.to(torch.float32)
        if decay:
            delta.add_(cfg.weight_decay * p32)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p32 - delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics

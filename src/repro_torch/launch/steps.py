"""The train step of the launchers (port of the train half of
``repro.launch.steps``).

Only ``make_train_step_fn`` is here.  The JAX module's sharding rules and
step builders (``param_specs``, ``batch_specs``, ``cache_specs``,
``shardings``, ``build_step``, ``lower_step``) and its prefill and decode
step builders wait for M11c, when a mesh comes to the port; on one card
the step runs unsharded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.trainer import value_and_grad
from repro_torch.utils.tree import tree_map


def make_train_step_fn(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                       microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over equal slices
    of the batch (their mean), so the activation peak scales with
    B/microbatches while the optimizer step sees the full-batch gradient.
    As in the JAX package, the metrics are then the last slice's.  The
    AdamW update runs in place (``adamw_update``)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, batch):
        if microbatches > 1:
            n = microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = None
            for i in range(n):
                mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in batch.items()}
                (_, metrics), g = value_and_grad(model.loss_fn, params, mb)
                grads = tree_map(
                    lambda a, gi: a + gi.to(torch.float32) / n, grads, g)
        else:
            (_, metrics), grads = value_and_grad(model.loss_fn, params, batch)
        new_params, new_opt, om = adamw_update(opt_cfg, grads, opt_state,
                                               params)
        return new_params, new_opt, {**metrics, **om}

    return step

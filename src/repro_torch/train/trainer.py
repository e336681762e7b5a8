"""Training loop: the train step with optional remat, metrics, checkpoints
(port of ``repro.train.trainer``).

Single-process training loop used by the tests and ``chip_smoke.py``; the
launcher (``launch/train.py``) runs the same step through
``launch.steps.make_train_step_fn``.  Gradients come from
``torch.autograd.grad`` over the param tree's leaves
(:func:`value_and_grad`); the AdamW update runs in place
(``optimizer.adamw_update``), so the returned state holds the tensors it
was given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models.api import Model, build_model
from repro_torch.serving.engine import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update)
from repro_torch.utils.tree import tree_leaves, tree_unflatten


@dataclass
class TrainState:
    params: Any
    opt: AdamWState


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(loss_fn, has_aux=True)`` gives
    them: the grads a tree shaped like ``params`` (zeros for a leaf the
    loss does not read), the loss and metrics detached.  The gradients are
    taken with respect to detached aliases of the leaves, so the caller's
    tensors keep ``requires_grad`` off."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    remat: bool = False) -> Callable:
    """(state, batch) -> (state, metrics).  ``remat`` checkpoints the whole
    loss, as ``jax.checkpoint(loss_fn)`` does in the JAX package."""
    loss_fn = model.loss_fn
    if remat:
        def loss_fn(params, batch):
            return checkpoint(model.loss_fn, params, batch,
                              use_reentrant=False)

    def step(state: TrainState, batch) -> tuple:
        (loss, metrics), grads = value_and_grad(loss_fn, state.params, batch)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state.opt, state.params)
        metrics = {**metrics, **opt_metrics, "total_loss": loss}
        return TrainState(new_params, new_opt), metrics

    return step


def to_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@dataclass
class Trainer:
    cfg: ModelConfig
    batch: int = 8
    seq: int = 128
    opt_cfg: AdamWConfig = field(default_factory=AdamWConfig)
    remat: bool = False
    seed: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = build_model(self.cfg)
        self.data = SyntheticLM(self.cfg, self.batch, self.seq,
                                seed=self.seed)
        self._step = make_train_step(self.model, self.opt_cfg, self.remat)

    def init_state(self) -> TrainState:
        """Random weights from a ``torch.Generator`` on the device, seeded
        with ``seed``, and a fresh AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = self.model.init(gen)
        return TrainState(params, adamw_init(params))

    def run(self, steps: int, state: Optional[TrainState] = None,
            log_every: int = 10, checkpoint_path: Optional[str] = None,
            log: Callable[[str], None] = print) -> tuple:
        """``steps`` train steps from ``state`` (``init_state()`` when
        None; a state built elsewhere, e.g. bridged from the JAX package,
        is trained in place).  Returns (state, history): a row of floats
        every ``log_every`` steps and at the last."""
        state = state or self.init_state()
        history: List[Dict[str, float]] = []
        for i in range(steps):
            batch = to_batch(self.data.next_batch(), self.device)
            state, metrics = self._step(state, batch)
            if i % log_every == 0 or i == steps - 1:
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = i
                history.append(row)
                log(f"step {i:5d}  loss={row['loss']:.4f}  "
                    f"grad_norm={row['grad_norm']:.3f}  lr={row['lr']:.2e}")
        if checkpoint_path:
            ckpt.save(checkpoint_path, (state.params, state.opt))
        return state, history

"""Model API (port of ``repro.models.api``: the transformer family, dense,
MoE and VLM; the recurrent, hybrid and audio families are not ported yet).

``build_model`` returns a :class:`Model` whose members are plain
functions over a params dict, as in the JAX package.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig

Params = Any
Cache = Any


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]              # (torch.Generator) -> params
    prefill: Callable[..., Any]              # (params, batch, cache_len) -> (last logits, cache)
    decode_step: Callable[..., Any]          # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable[..., Cache]         # (batch, cache_len, device)
    # (params, pages, table, tokens, pos) -> (logits, pages); None for a
    # family without a slot-cache layout the block arena can virtualize
    decode_step_paged: Any = None
    loss_fn: Any = None                      # (params, batch) -> (loss, metrics)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  mask=None) -> torch.Tensor:
    """Mean CE over valid tokens; logits (B, S, Vp) with Vp >= vocab (the
    padded vocab columns are masked out)."""
    logits = logits.to(torch.float32)
    Vp = logits.shape[-1]
    if Vp > vocab:
        pad = torch.arange(Vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad[None, None, :], -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, moe and vlm "
            f"are)")
    from repro_torch.models import transformer
    return Model(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
        decode_step_paged=functools.partial(transformer.decode_step_paged,
                                            cfg),
        loss_fn=functools.partial(transformer.loss_fn, cfg),
    )

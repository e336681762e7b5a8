"""Model API (port of ``repro.models.api``, dense family only).

``build_model`` returns a :class:`Model` whose members are plain
functions over a params dict, as in the JAX package.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

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


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    from repro_torch.models import transformer
    return Model(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
    )

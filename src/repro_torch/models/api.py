"""Model API (port of ``repro.models.api``) for all six families: the
transformer family (dense, MoE, VLM: ``models.transformer``), the
recurrent family (``ssm``: xLSTM, ``models.xlstm``), the hybrid
(``models.zamba``: Mamba2 + a shared attention block) and the audio
encoder-decoder (``models.whisper``).

``build_model`` returns a :class:`Model` whose members are plain
functions over a params dict, as in the JAX package.  Every family's cache
is a list of per-layer dicts whose leaves hold the batch on axis 0, so the
serving engine splices refilled rows the same way for all of them.  What
the engine asks of a family its module states, where it differs from
``build_model``'s default [in brackets]:
- ``KERNEL_WEIGHTS`` [False]: True in the transformer's, whose quantized
  trees keep QTensor leaves on ``quant_matmul`` and whose decode steps
  take ``use_kernel``; other trees are dequantized at load (the JAX way).
- ``decode_tier`` ["none"]: the transformer's ``kops.decode_kernel_tier``,
  the published Zamba2 layout's "flash".
- ``prompt_batch`` [the tokens]: a VLM and Whisper add zero stub embeddings.
- ``state_bytes`` [None]: Zamba2's SSM and conv state bytes a step moves.
- ``decode_step_paged`` [None]: the transformer's arena step.  xLSTM
  keeps every default.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, ShapeConfig

Params = Any
Cache = Any

# The subtrees the JAX package stacks on leading layer axes (it scans over
# layers), and the number of those axes; the port keeps each as a list of
# per-layer dicts (``bridge`` slices them, ``train.optimizer`` counts the
# axes back where AdamW's decay rule reads a leaf's rank).
STACKED = {"layers": 1, "main": 2, "tail": 1, "mlstm": 2, "slstm": 1,
           "enc_layers": 1, "dec_layers": 1}


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
    input_specs: Any = None                  # (ShapeConfig) -> meta tensors
    kernel_weights: bool = False             # serve QTensor trees, use_kernel
    decode_tier: Callable = lambda params: "none"   # -> decode-attention tier
    prompt_batch: Callable = lambda tokens: {"tokens": tokens}  # prefill's
    state_bytes: Callable = lambda cache: None      # bytes a step moves


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  mask=None) -> torch.Tensor:
    """Mean CE over valid tokens; logits (B, S, Vp) with Vp >= vocab (the
    padded vocab columns are masked out).  Under a mesh the gold logit is
    a one-hot masked sum, which each device takes over its own columns:
    the same value (one term is nonzero), where DTensor's gather would
    replicate the logits and their gradient."""
    from repro_torch.utils.sharding import on_mesh
    logits = logits.to(torch.float32)
    Vp = logits.shape[-1]
    if Vp > vocab:
        pad = torch.arange(Vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad[None, None, :], -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    if on_mesh(logits):
        cols = torch.arange(Vp, device=logits.device)
        gold = torch.sum(torch.where(cols == labels.long()[..., None],
                                     logits, 0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.models import transformer, whisper, xlstm, zamba
    mod = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": xlstm, "hybrid": zamba, "audio": whisper}[cfg.family]
    own = {name: functools.partial(getattr(mod, name), cfg)
           for name in ("decode_step_paged", "decode_tier", "prompt_batch",
                        "state_bytes") if hasattr(mod, name)}
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init_params, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        loss_fn=functools.partial(mod.loss_fn, cfg),
        input_specs=functools.partial(mod.input_specs, cfg),
        kernel_weights=getattr(mod, "KERNEL_WEIGHTS", False), **own)


def meta(shape, dtype) -> torch.Tensor:
    """A meta-device tensor: a shape and a dtype, no storage (the
    counterpart of ``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def token_specs(shape: ShapeConfig, n_text: int = 0):
    """The token inputs of a step of ``shape``: (B, n_text or S) tokens
    and, for train, labels; (B, 1) tokens for decode."""
    B = shape.global_batch
    n = n_text or shape.seq_len
    if shape.kind == "train":
        return {"tokens": meta((B, n), torch.int32),
                "labels": meta((B, n), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": meta((B, n), torch.int32)}
    # decode: one new token against a cache of length S
    return {"tokens": meta((B, 1), torch.int32)}

"""Measured quantization effects: alpha (memory), beta (speed), dPPL
(port of ``repro.quant.calibration``).

The paper takes alpha/beta/dPPL from offline exhaustive evaluation ([10],
Table II).  Here all three are *measured* on the actual PyTorch models:

  * ``measure_alpha``  — bytes(quantized tree) / bytes(fp tree);
  * ``measure_beta``   — decode-throughput ratio tok/s(fp) / tok/s(method)
    timed on the REAL ServingEngine per (method, batch);
  * ``measure_dppl``   — perplexity difference between the fp and the
    weight-quantized model on a fixed synthetic eval set (real models would
    use WikiText; the machinery is identical).

``calibrate`` packages alpha/dPPL into a ``QuantMethod``-compatible record;
``calibrate_engine`` + ``measured_methods`` close the loop for the
SCHEDULER: the measured alpha/beta land in real ``QuantMethod`` records
(via the ``alpha_*_measured`` overrides and a ``beta`` replace), so every
``P2Coefficients`` and ``quant=auto`` descent runs on coefficients of the
engine that will actually serve the decision instead of the paper's table.
The table remains the default so the reproduction is exact.

This copy differs from the JAX package's in its imports and in these
places: a record's ``"backend"`` is the engine's torch device type
(``"cuda"`` or ``"cpu"``); the timers synchronize a CUDA engine's device
before they read the clock; ``synthetic_eval_batch`` draws its tokens with
numpy (the JAX package draws them with ``jax.random``, whose numbers torch
cannot reproduce: hand both packages the same batch to compare them) onto
the params' device, and covers dense models only.  On a CUDA engine the int8 methods are measured through the fused
decode kernels (K6/K7) where the model takes that tier.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.quant.ptq import (dequantize_tree, quantize_tree,
                                   tree_bytes, tree_leaves)


def measure_alpha(params: Any, bits: int = 8) -> Tuple[float, int, int]:
    """(alpha_w, fp_bytes, q_bytes) for weight quantization at ``bits``."""
    fp = tree_bytes(params)
    q = tree_bytes(quantize_tree(params, bits))
    return q / fp, fp, q


def synthetic_eval_batch(cfg: ModelConfig, batch: int = 4, seq: int = 128,
                         seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministic token stream with Zipfian marginals (PPL eval stand-in).
    Dense models only (no patch or audio embeddings)."""
    rng = np.random.default_rng(seed)
    # Zipf-ish: exponential rank distribution over the true vocab
    u = rng.uniform(1e-6, 1.0, size=(batch, seq + 1)).astype(np.float32)
    ranks = np.floor(-np.log(u) * cfg.vocab / 8.0).astype(np.int64)
    toks = torch.from_numpy(np.clip(ranks, 0, cfg.vocab - 1)).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _device_of(params: Any) -> torch.device:
    """The device of a (possibly quantized) param tree."""
    leaf = next(l for l in tree_leaves(params) if l is not None)
    return getattr(leaf, "q", leaf).device


@torch.no_grad()
def model_ppl(cfg: ModelConfig, params: Any,
              batch: Optional[Dict[str, torch.Tensor]] = None) -> float:
    model = build_model(cfg)
    batch = batch or synthetic_eval_batch(cfg, device=_device_of(params))
    loss, _ = model.loss_fn(params, batch)
    return float(math.exp(float(loss)))


def measure_dppl(cfg: ModelConfig, params: Any, bits: int = 8,
                 batch: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[float, float, float]:
    """(dPPL, ppl_fp, ppl_quant) with weight-only RTN at ``bits``."""
    batch = batch or synthetic_eval_batch(cfg, device=_device_of(params))
    ppl_fp = model_ppl(cfg, params, batch)
    qparams = dequantize_tree(quantize_tree(params, bits))
    ppl_q = model_ppl(cfg, qparams, batch)
    return ppl_q - ppl_fp, ppl_fp, ppl_q


def calibrate(cfg: ModelConfig, params: Any, bits: int = 8,
              batch: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, float]:
    """Measured (alpha_w, dPPL) record for this model + precision."""
    alpha, fp_bytes, q_bytes = measure_alpha(params, bits)
    dppl, ppl_fp, ppl_q = measure_dppl(cfg, params, bits, batch)
    return {"alpha_w": alpha, "fp_bytes": fp_bytes, "q_bytes": q_bytes,
            "dppl": dppl, "ppl_fp": ppl_fp, "ppl_quant": ppl_q,
            "bits": bits}


# ---------------------------------------------------------------------------
# Measured beta: time the REAL engine per (method, batch)
# ---------------------------------------------------------------------------


def _sync(engine) -> None:
    """Wait for a CUDA engine's device (nothing on the CPU)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _time_tok_s(engine, prompts, caps, bits) -> float:
    """One timed generate() call -> emitted tokens per second."""
    _sync(engine)
    t0 = time.perf_counter()
    result = engine.generate(prompts, n_tokens=caps, quant_bits=bits)
    _sync(engine)
    dt = time.perf_counter() - t0
    return float(result.lengths.sum()) / max(dt, 1e-9)


def measure_beta(engine, methods: Optional[Sequence] = None,
                 batches: Sequence[int] = (1, 4, 8), iters: int = 3,
                 n_tokens: int = 32, prompt_len: int = 8,
                 min_batch: int = 4, seed: int = 0) -> Dict[str, Any]:
    """Measure beta (compute-time scale vs fp16) per (method, batch) on a
    real :class:`ServingEngine`.

    For every batch size, fp and the method's ``serve_bits`` are timed
    INTERLEAVED (fp, m, fp, m, ...) best-of-``iters`` — back-to-back
    pairs cancel machine-load drift, best-of cancels one-sided stalls.
    ``beta = tok_s(fp) / tok_s(method)`` (>1 ⇒ slower than fp); the
    scalar per-method beta is the median over batches >= ``min_batch``
    (small batches are latency-bound and noisy — the paper's beta is a
    throughput-regime number).  Both compilations are warmed before any
    timer starts.  Returns a JSON-able record (see ``measured_methods``).
    """
    from repro_torch.core.quantization import METHODS
    methods = list(METHODS.values()) if methods is None else list(methods)
    rng = np.random.default_rng(seed)
    record: Dict[str, Any] = {"batches": [int(b) for b in batches],
                              "iters": int(iters),
                              "backend": engine.device.type,
                              "arch": engine.cfg.arch_id,
                              "methods": {}}
    for m in methods:
        per_batch, fp_per_batch, m_per_batch = {}, {}, {}
        for b in batches:
            nb = min(int(b), engine.batch_capacity)
            prompts = [rng.integers(1, engine.cfg.vocab,
                                    size=prompt_len).tolist()
                       for _ in range(nb)]
            caps = [n_tokens] * nb
            # warm both executables (compile + quantize-once) off-clock
            engine.generate(prompts, n_tokens=caps, quant_bits=0)
            engine.generate(prompts, n_tokens=caps, quant_bits=m.serve_bits)
            fp_best = q_best = 0.0
            for _ in range(iters):
                fp_best = max(fp_best,
                              _time_tok_s(engine, prompts, caps, 0))
                q_best = max(q_best, _time_tok_s(engine, prompts, caps,
                                                 m.serve_bits))
            per_batch[str(b)] = fp_best / q_best
            fp_per_batch[str(b)] = fp_best
            m_per_batch[str(b)] = q_best
        eligible = [per_batch[str(b)] for b in batches
                    if int(b) >= min_batch] or list(per_batch.values())
        record["methods"][m.name] = {
            "beta": float(np.median(eligible)),
            "per_batch": per_batch,
            "tok_s_fp": fp_per_batch,
            "tok_s": m_per_batch,
        }
    return record


def measure_swap_cost(engine, methods: Optional[Sequence] = None,
                      iters: int = 3, n_tokens: int = 2,
                      prompt_len: int = 4, seed: int = 0) -> Dict[str, Any]:
    """Measure the weight-swap latency between every pair of canonical
    serving precisions on a real :class:`ServingEngine`.

    A "swap" is what a split epoch pays between sub-batches: the engine
    re-serves through ``params_for`` with a different precision's tree
    from the multi-precision weight cache (plus the executable re-dispatch
    against the other donated buffers).  For every ordered pair ``a -> b``
    of distinct canonical bit specs the transition is timed INTERLEAVED
    best-of-``iters`` against its own stay-at-``b`` control:

        generate(a); T_swap = time(generate(b))     # swapped residency
        generate(b); T_stay = time(generate(b))     # warm residency

    ``swap_s = max(0, min T_swap - min T_stay)`` — back-to-back pairs
    cancel machine-load drift, best-of cancels one-sided stalls, and the
    stay control subtracts the cost of serving itself so only the
    transition overhead remains.  Both executables and every precision's
    cache entry are warmed off-clock first.  Methods sharing a canonical
    spec (e.g. W8A16/W8A8 on interpret backends, where
    ``_canon_bits`` folds (8, 8) -> 8) swap for free and get no pair.

    Returns a JSON-able record consumed by
    ``core.quantization.swap_seconds`` and the split descent
    (``core.dftsp.dftsp_schedule_split``); ``default_s`` is the worst
    measured pair, the fallback for unmeasured transitions.
    """
    from repro_torch.core.quantization import METHODS
    methods = list(METHODS.values()) if methods is None else list(methods)
    canon = getattr(engine, "_canon_bits", lambda b: b)
    rng = np.random.default_rng(seed)
    nb = min(2, engine.batch_capacity)
    prompts = [rng.integers(1, engine.cfg.vocab, size=prompt_len).tolist()
               for _ in range(nb)]
    caps = [n_tokens] * nb

    by_key: Dict[str, Any] = {}
    names: Dict[str, str] = {}
    for m in methods:
        key = str(canon(m.serve_bits))
        names[m.name] = key
        by_key.setdefault(key, m.serve_bits)

    record: Dict[str, Any] = {"iters": int(iters),
                              "backend": engine.device.type,
                              "arch": engine.cfg.arch_id,
                              "batch": nb, "n_tokens": int(n_tokens),
                              "methods": names, "pairs": {},
                              "default_s": 0.0}
    # warm every precision's executable + weight-cache entry off-clock
    for bits in by_key.values():
        engine.generate(prompts, n_tokens=caps, quant_bits=bits)

    def _timed(bits) -> float:
        _sync(engine)
        t0 = time.perf_counter()
        engine.generate(prompts, n_tokens=caps, quant_bits=bits)
        _sync(engine)
        return time.perf_counter() - t0

    keys = sorted(by_key)
    for ka in keys:
        for kb in keys:
            if ka == kb:
                continue
            a, b = by_key[ka], by_key[kb]
            t_swap = t_stay = float("inf")
            for _ in range(iters):
                engine.generate(prompts, n_tokens=caps, quant_bits=a)
                t_swap = min(t_swap, _timed(b))
                engine.generate(prompts, n_tokens=caps, quant_bits=b)
                t_stay = min(t_stay, _timed(b))
            swap_s = max(0.0, t_swap - t_stay)
            record["pairs"][f"{ka}->{kb}"] = {
                "swap_s": swap_s, "t_swap": t_swap, "t_stay": t_stay}
            record["default_s"] = max(record["default_s"], swap_s)
    return record


def attach_alphas(record: Dict[str, Any], params: Any) -> Dict[str, Any]:
    """Add measured weight alphas (tree-bytes ratios) to a ``measure_beta``
    record in place, so the SAVED record fully determines the
    ``measured_methods`` reconstruction (the committed-artifact pinned
    tests rebuild methods from JSON alone, no re-timing)."""
    cache: Dict[int, float] = {}
    for name, meas in record["methods"].items():
        from repro_torch.core.quantization import METHODS
        w = METHODS[name].weight_bits
        if w < 16:
            if w not in cache:
                cache[w] = measure_alpha(params, w)[0]
            meas["alpha_w"] = cache[w]
    return record


def measured_methods(record: Dict[str, Any],
                     round_to: float = 0.25) -> Dict[str, Any]:
    """Package a ``measure_beta`` record into real :class:`QuantMethod`
    records for the scheduler.

    Betas are snapped to a ``round_to`` grid: the scheduler's method
    ORDERING must not hang on run-to-run timing noise, so methods within
    the same grid cell are declared speed-equivalent and the descent
    falls through to the accuracy/memory axes (exactly what makes the
    measured coefficients change decisions — e.g. when W8A8 and W8A16
    measure at parity, W8A16's strictly better dPPL Pareto-dominates and
    W8A8 drops out of the candidate set).  Weight alphas come from the
    record when ``attach_alphas`` ran; ``alpha_a_measured`` is pinned at
    1.0 — the engine's KV/activation residency is fp unless the separate
    ``kv_bits`` path is on, which no weight method changes.
    """
    from repro_torch.core.quantization import METHODS
    out = {}
    for name, meas in record["methods"].items():
        base = METHODS[name]
        beta = meas["beta"]
        if round_to > 0:
            beta = round(beta / round_to) * round_to
        kw: Dict[str, Any] = {"beta": float(beta)}
        if base.weight_bits < 16:
            kw["alpha_a_measured"] = 1.0
            if "alpha_w" in meas:
                kw["alpha_w_measured"] = float(meas["alpha_w"])
        out[name] = dataclasses.replace(base, **kw)
    return out

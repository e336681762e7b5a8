"""Batched-inference engine (port of the epoch half of
``repro.serving.engine``): executes scheduled batches on the PyTorch model.

A scheduled batch of prompts is padded to the epoch's s' (the paper's
'extend all prompts to the maximum length' assumption), prefilled in one
pass, then decoded greedily with sampling, EOS detection and per-request
output caps all on the device.  Per ``generate`` call there is exactly ONE
host->device copy (prompts and caps, in one tensor) and ONE device->host
copy (tokens and lengths, in one tensor).

Eager PyTorch has no device-side ``while_loop``, so the host runs the loop
for ``min(n_max, max(caps))`` steps (a number it already knows) and masks
every row on the device; it never reads a device value inside the loop.
The JAX package's loop exits once no row can emit; the rows this loop
keeps stepping after that never emit again, so the tokens are the same.
``generate_reference`` is the host-driven loop with one device->host copy
per token, kept as the oracle ``generate`` must equal bit for bit.

Weights can be served quantized: ``quant_bits`` picks the default
precision and ``generate(..., quant_bits=...)`` serves one batch at the
precision the scheduler decided.  Each precision is quantized once from
the full-precision weights and cached (``params_for``).  A precision is an
int (weight bits) or a ``(weight_bits, act_bits)`` pair; ``(8, 8)`` is
W8A8.  Quantized trees keep their QTensor leaves on every device: on a
CUDA device they run through the hand-written kernels, on the CPU through
the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch
from repro_torch.models.api import Model, build_model
from repro_torch.quant.ptq import quantize_tree


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_max) generated ids (post-prompt)
    lengths: np.ndarray         # (B,) emitted length per request
    batch: int


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no quiet
    fallback to the CPU: pass ``device="cpu"`` to run there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def tiny_engine(arch_id: str, **engine_kw) -> "ServingEngine":
    """A CPU-sized reduced engine for ``arch_id`` (1 layer, d_model 64,
    vocab 256), the same reduced shape as the JAX package's
    ``tiny_engine``.  ``engine_kw`` passes through to ``ServingEngine``."""
    cfg = get_arch(arch_id).scaled(n_layers=1, d_model=64, n_heads=2,
                                   n_kv_heads=2, d_ff=128, vocab=256)
    return ServingEngine(cfg, **engine_kw)


class ServingEngine:
    """Fixed-shape batched prefill + masked greedy decode for one model."""

    def __init__(self, cfg: ModelConfig, params: Any = None,
                 batch_capacity: int = 8, s_max: int = 512,
                 n_max: int = 128, quant_bits: int = 0,
                 eos_id: int = 0, seed: int = 0,
                 use_kernel: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = build_model(cfg)
        self.batch_capacity = batch_capacity
        self.s_max = s_max
        self.n_max = n_max
        self.eos_id = eos_id
        # decode attention through flash_decode; the plain masked softmax
        # (use_kernel=False) serves the CPU only
        if not use_kernel and self.device.type == "cuda":
            raise ValueError("use_kernel=False runs on the CPU only; on "
                             "CUDA decode attention is the flash_decode "
                             "kernel")
        self.use_kernel = bool(use_kernel)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self._raw_params = params            # full precision master copy
        self._params_cache: dict = {}        # precision -> param tree
        self.default_bits = self._canon_bits(quant_bits)
        self.params = self.params_for(quant_bits)
        self.precisions_served: set = set()  # precisions generate() ran at
        self.cache_len = s_max + n_max

    # -- multi-precision weight cache ---------------------------------------

    @staticmethod
    def _canon_bits(bits):
        """Canonical precision spec: an int (weight bits; 0/16 both mean
        full precision) or a ``(weight_bits, act_bits)`` pair (a
        QuantMethod.serve_bits; W8A8 serves as ``(8, 8)``).  A pair with
        fp activations collapses to its int; ``(8, 8)`` stays distinct
        from ``8`` on every device, since both run as quantized trees."""
        if isinstance(bits, (tuple, list)):
            w, a = bits
            w = 0 if not w or w >= 16 else int(w)
            a = 16 if not a or a >= 16 else int(a)
            if w == 0 or a == 16:
                return w
            return (w, a)
        return 0 if not bits or bits >= 16 else int(bits)

    def params_for(self, bits):
        """Weights at ``bits`` precision (int or (w, a) pair), quantized
        once and cached so the scheduler can swap the served method every
        epoch."""
        bits = self._canon_bits(bits)
        if bits not in self._params_cache:
            if bits == 0:
                p = self._raw_params
            else:
                w, a = bits if isinstance(bits, tuple) else (bits, 16)
                p = quantize_tree(self._raw_params, w, act_bits=a)
            self._params_cache[bits] = p
        return self._params_cache[bits]

    # -- public API ----------------------------------------------------------

    def synth_prompts(self, requests: Sequence, rng: np.random.Generator):
        """Synthesize random-token prompts + output caps for scheduled
        requests, clamped to this engine's static shapes."""
        prompts = [rng.integers(1, self.cfg.vocab,
                                size=min(r.s, self.s_max)).tolist()
                   for r in requests]
        caps = [min(r.n, self.n_max) for r in requests]
        return prompts, caps

    def pad_prompts(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        """Left-truncate/right-align prompts to (batch_capacity, s_max)."""
        B = self.batch_capacity
        out = np.zeros((B, self.s_max), np.int32)
        for i, p in enumerate(prompts[:B]):
            p = list(p)[-self.s_max:]
            out[i, -len(p):] = p        # right-aligned => last slot is last
        return out

    def _prepare(self, prompts, n_tokens, quant_bits):
        """Resolve the weights and build the host batch: (params, padded
        prompts with the caps as one extra column (B, s_max + 1) int32,
        host caps, batch size)."""
        bits = self.default_bits if quant_bits is None \
            else self._canon_bits(quant_bits)
        params = self.params_for(bits)
        self.precisions_served.add(bits)
        B = self.batch_capacity
        nb = len(prompts)
        assert nb <= B, (nb, B)
        caps = np.full((B,), self.n_max, np.int32)
        if n_tokens is not None:
            caps[:nb] = np.minimum(np.asarray(n_tokens, np.int32), self.n_max)
        caps[nb:] = 0
        host = np.concatenate([self.pad_prompts(prompts), caps[:, None]], 1)
        return params, torch.from_numpy(host), caps, nb

    def _prefill(self, params, tokens):
        """Prompt pass; returns (first sampled token (B,), KV cache)."""
        logits, cache = self.model.prefill(params, {"tokens": tokens},
                                           self.cache_len)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    def _decode(self, params, cache, cur, t):
        logits, cache = self.model.decode_step(
            params, cache, cur[:, None], self.s_max + t,
            use_kernel=self.use_kernel)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    @torch.no_grad()
    def generate(self, prompts: Sequence[Sequence[int]],
                 n_tokens: Optional[Sequence[int]] = None,
                 greedy: bool = True,
                 quant_bits: Optional[int] = None) -> GenerationResult:
        """Prefill + masked greedy decode of one batch.

        ``n_tokens`` caps each request's output; ``quant_bits`` serves this
        batch at an explicit precision (``None``: the engine default).
        One host->device and one device->host copy per call."""
        params, host, caps, nb = self._prepare(prompts, n_tokens, quant_bits)
        B = self.batch_capacity
        dev = host.to(self.device)                    # the one H2D copy
        tokens, caps_d = dev[:, :self.s_max], dev[:, self.s_max]
        cur, cache = self._prefill(params, tokens)
        out = torch.zeros((B, self.n_max), dtype=cur.dtype, device=self.device)
        lengths = torch.zeros((B,), dtype=cur.dtype, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        for t in range(min(self.n_max, int(caps.max(initial=0)))):
            alive = (~done) & (caps_d > t)
            out[:, t] = torch.where(alive, cur, out[:, t])
            lengths += alive
            done |= (cur == self.eos_id) & alive
            cur, cache = self._decode(params, cache, cur, t)
        res = torch.cat([out, lengths[:, None]], 1).cpu().numpy()  # one D2H
        res = res.astype(np.int32)
        return GenerationResult(tokens=res[:nb, :-1], lengths=res[:nb, -1],
                                batch=nb)

    @torch.no_grad()
    def generate_reference(self, prompts: Sequence[Sequence[int]],
                           n_tokens: Optional[Sequence[int]] = None,
                           greedy: bool = True,
                           quant_bits: Optional[int] = None
                           ) -> GenerationResult:
        """The host-driven decode loop: one device->host copy PER TOKEN.
        ``generate`` must match it bit for bit."""
        params, host, caps, nb = self._prepare(prompts, n_tokens, quant_bits)
        B = self.batch_capacity
        tokens = host[:, :self.s_max].to(self.device)
        cur_d, cache = self._prefill(params, tokens)
        cur = cur_d.cpu().numpy().astype(np.int32)

        out = np.zeros((B, self.n_max), np.int32)
        lengths = np.zeros((B,), np.int32)
        done = np.zeros((B,), bool)
        for t in range(int(caps.max(initial=0))):
            alive = (~done) & (t < caps)
            if not alive.any():
                break
            out[alive, t] = cur[alive]
            lengths[alive] += 1
            done |= (cur == self.eos_id) & alive
            step_tok = torch.from_numpy(cur).to(self.device)
            cur_d, cache = self._decode(params, cache, step_tok, t)
            cur = cur_d.cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=out[:nb], lengths=lengths[:nb],
                                batch=nb)

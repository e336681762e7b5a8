"""Shared fixtures: reduced model configs for CPU-scale testing.

NOTE: no XLA_FLAGS here — smoke tests and benches must see the host's
real device count (the 512-device override belongs ONLY to the dry-run).
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.config import (EncDecConfig, MoEConfig, ModelConfig, get_arch)

# Reduced variants of each assigned family (2 layers, d_model <= 512,
# <= 4 experts) used by the per-arch smoke tests.
REDUCTIONS = {
    "xlstm-1.3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       vocab=512),
    "mistral-large-123b": dict(n_layers=2, d_model=256, n_heads=8,
                               n_kv_heads=2, d_ff=512, vocab=512),
    "internvl2-26b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=512),
    "olmo-1b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                    d_ff=256, vocab=512),
    "whisper-tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=512),
    "mixtral-8x22b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512),
    "deepseek-coder-33b": dict(n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512),
    "zamba2-7b": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512),
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=128, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab=512),
    "qwen3-1.7b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512),
    "bloom-3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     d_ff=512, vocab=512),
    "bloom-7b1": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=512, vocab=512),
    "opt-13b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                    d_ff=512, vocab=512),
}


def reduced_cfg(arch_id: str) -> ModelConfig:
    cfg = get_arch(arch_id).scaled(**REDUCTIONS[arch_id])
    if cfg.is_moe and cfg.moe.n_experts > 4:
        cfg = dataclasses.replace(
            cfg, moe=MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2)))
    if cfg.family == "audio":
        cfg = dataclasses.replace(
            cfg, encdec=EncDecConfig(n_enc_layers=2, n_audio_frames=32))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg


@pytest.fixture
def rng_key():
    import jax
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")

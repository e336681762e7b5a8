"""Qwen3-1.7B — qk-norm, GQA [hf:Qwen/Qwen3-8B family card]."""
from repro_torch.config import ModelConfig, register_arch

QWEN3_1_7B = register_arch(ModelConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    norm="rmsnorm",
    act="silu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (1.7B sibling card)",
))

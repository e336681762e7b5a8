"""Granite-3.0-1B-A400M — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

GRANITE_MOE_1B_A400M = register_arch(ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                # per expert
    vocab=49155,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="vocab 49155 padded to 49408 for model-parallel vocab sharding.",
))

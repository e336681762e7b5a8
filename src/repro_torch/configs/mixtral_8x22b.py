"""Mixtral-8x22B — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

MIXTRAL_8X22B = register_arch(ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,              # per expert
    vocab=32768,
    norm="rmsnorm",
    act="silu",
    sliding_window=4096,     # per the assignment (SWA)
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088 (Mixtral of Experts)",
    notes="SWA bounds the decode KV cache to the window => long_500k applies.",
))

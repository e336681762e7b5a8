"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.config import HybridConfig, ModelConfig, SSMConfig, register_arch

ZAMBA2_7B = register_arch(ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    norm="rmsnorm",
    act="silu",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128, conv_width=4),
    hybrid=HybridConfig(attn_every=6, shared_attn=True),
    source="arXiv:2411.15242 (Zamba2)",
    notes="81 Mamba2 layers; one SHARED attention+FFN block applied every "
          "6th layer (weights reused). O(1) SSM decode state => long_500k "
          "applies; the shared-attn KV cache at the attn sites is the only "
          "seq-dependent memory and is windowed to 4096 for long_500k.",
))

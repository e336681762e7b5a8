"""DeepSeek-Coder-33B — llama-arch [arXiv:2401.14196]."""
from repro_torch.config import ModelConfig, register_arch

DEEPSEEK_CODER_33B = register_arch(ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    norm="rmsnorm",
    act="silu",
    rope_theta=100_000.0,
    source="arXiv:2401.14196 (DeepSeek-Coder)",
))

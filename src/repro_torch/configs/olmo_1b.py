"""OLMo-1B — non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.config import ModelConfig, register_arch

OLMO_1B = register_arch(ModelConfig(
    arch_id="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparam_ln",      # OLMo uses LN without learnable affine params
    act="silu",
    tie_embeddings=True,
    source="arXiv:2402.00838 (OLMo: Accelerating the Science of LMs)",
))

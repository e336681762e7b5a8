"""OPT-13B — one of the paper's own simulation models (Table I)."""
from repro_torch.config import ModelConfig, register_arch

OPT_13B = register_arch(ModelConfig(
    arch_id="opt-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=4 * 5120,
    vocab=50272,
    norm="layernorm",
    act="relu",             # OPT uses ReLU (matches the paper's f_relu eqs)
    tie_embeddings=True,
    source="paper Table I [2]; hf:facebook/opt-13b",
))

"""BLOOM-3B — one of the paper's own simulation models (Table I)."""
from repro_torch.config import ModelConfig, register_arch

BLOOM_3B = register_arch(ModelConfig(
    arch_id="bloom-3b",
    family="dense",
    n_layers=30,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=4 * 2560,          # "The FFN's dimension is four times the model's"
    vocab=250880,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    source="paper Table I [2]; hf:bigscience/bloom-3b",
))

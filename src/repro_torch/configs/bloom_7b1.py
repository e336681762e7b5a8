"""BLOOM-7.1B — one of the paper's own simulation models (Table I)."""
from repro_torch.config import ModelConfig, register_arch

BLOOM_7B1 = register_arch(ModelConfig(
    arch_id="bloom-7b1",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=4 * 4096,
    vocab=250880,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    source="paper Table I [2]; hf:bigscience/bloom-7b1",
))

"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.config import ModelConfig, register_arch

MISTRAL_LARGE_123B = register_arch(ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    notes="Pure full attention => long_500k skipped (DESIGN.md §4); the "
          "beyond-paper SWA variant is reported separately in §Perf.",
))

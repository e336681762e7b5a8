"""InternVL2-26B language backbone (InternLM2-20B-style) [arXiv:2404.16821].

The vision side (InternViT-6B + MLP projector) is a STUB per the assignment:
``input_specs`` provides precomputed patch embeddings of shape
``(batch, n_img_tokens, d_model)``; this config describes the transformer
decoder that consumes them.
"""
from repro_torch.config import ModelConfig, VLMConfig, register_arch

INTERNVL2_26B = register_arch(ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    norm="rmsnorm",
    act="silu",
    vlm=VLMConfig(n_img_tokens=256),
    source="arXiv:2404.16821 (InternVL2); LM backbone InternLM2",
    notes="vocab 92553 padded to 92672 (multiple of 256) for 16-way vocab "
          "sharding; logits masked beyond the true vocab.",
))

"""Zamba2-7B-Instruct at its published block
[hf:Zyphra/Zamba2-7B-Instruct config.json; arXiv:2411.15242].

81 Mamba2 layers (d_model 3584, 112 SSM heads of 64, d_state 64, two B/C
groups, a conv of width 4 with bias, chunk 256) and two shared attention
+ GeGLU blocks used in turn at the 13 ``hybrid_layer_ids``: each site
reads RMSNorm(concat(x, embedding)) (7168 wide, 32 heads of 224, rotary
over all 224 dims, scale (224 / 2)^-1/2), adds its own rank-128 adapter
to the MLP's gate/up projection and its own 3584 -> 3584 linear, and
feeds the result into the input of the Mamba2 layer at its id.

Assumed: ``tie_word_embeddings`` true (the Hugging Face default; the
published config.json does not set it).  Departures: the shared
attention's slot cache is windowed at ``models.zamba.ATTN_WINDOW`` =
4096, equal to ``max_position_embeddings``, so nothing is cut; dt =
softplus(dt + dt_bias) with no clamp, as the published kernel path with
``time_step_limit`` null (the ``transformers`` slow path clamps dt at
``time_step_min``).  At W8A16 only the leaves that ``quant.ptq``'s
``quantize_tree`` quantizes are int8: the shared blocks' projections and
the embedding table; the 81 Mamba2 layers' in_proj and out_proj (6.35 B
of the 7.36 B parameters) are served in bf16.
"""
from repro_torch.config import HybridConfig, ModelConfig, SSMConfig, register_arch

SITES = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

ZAMBA2_7B_INSTRUCT = register_arch(ModelConfig(
    arch_id="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=224,
    d_ff=14336,
    vocab=32000,
    norm="rmsnorm",
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256, conv_width=4,
                  n_groups=2, conv_bias=True),
    hybrid=HybridConfig(attn_every=6, shared_attn=True, sites=SITES,
                        adapter_rank=128),
    source="hf:Zyphra/Zamba2-7B-Instruct config.json; arXiv:2411.15242",
    notes="81 Mamba2 layers (2 B/C groups, conv bias); two shared "
          "attention + GeGLU blocks ABAB at 13 sites over concat(x, "
          "embedding), a rank-128 adapter and a linear per site; tied "
          "embeddings (assumed).",
))

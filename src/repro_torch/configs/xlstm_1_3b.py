"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.config import ModelConfig, XLSTMConfig, register_arch

XLSTM_1_3B = register_arch(ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # xLSTM blocks carry their own projections
    vocab=50304,
    norm="layernorm",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0,
                      proj_factor_slstm=4.0 / 3.0, conv_width=4),
    source="arXiv:2405.04517 (xLSTM: Extended Long Short-Term Memory)",
    notes="Recurrent matrix/scalar memory; decode state is O(1) in context "
          "length, so long_500k applies.",
))

"""Whisper-tiny — encoder-decoder with conv frontend stub [arXiv:2212.04356].

The mel-spectrogram + conv1d feature extractor is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings ``(batch, 1500, d_model)``
consumed by the transformer encoder; this config describes the enc-dec
transformer itself.  n_layers refers to the decoder stack.
"""
from repro_torch.config import EncDecConfig, ModelConfig, register_arch

WHISPER_TINY = register_arch(ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=4, n_audio_frames=1500),
    source="arXiv:2212.04356 (Robust Speech Recognition via Large-Scale "
           "Weak Supervision)",
    notes="decode_32k exercises a 32k self-attn cache mechanically even "
          "though real Whisper caps decoding at 448 positions (fidelity "
          "caveat recorded in DESIGN.md). Full attention => long_500k skipped.",
))

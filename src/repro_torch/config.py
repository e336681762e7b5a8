"""Configuration system of the PyTorch port (a copy of ``repro.config``).

Frozen dataclasses describing model architectures.  Every carried
architecture registers a ``ModelConfig`` via :func:`register_arch`; lookup
is by the canonical (dash-separated) id, e.g. ``get_arch("bloom-3b")``.
The TPU hardware, mesh, quantization and input-shape records of the
original are left out: nothing in this package reads them.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    # d_ff in ModelConfig is interpreted per-expert when n_experts > 0.


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block parameters (Mamba2 SSD & xLSTM)."""
    d_state: int = 64          # N in Mamba2; per-head state width
    head_dim: int = 64         # SSD head dim (P)
    expand: int = 2            # d_inner = expand * d_model
    chunk: int = 128           # chunk length for the chunked SSD scan
    conv_width: int = 4        # depthwise conv width in Mamba blocks


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8       # every k-th block is an sLSTM block, rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + periodically applied shared
    attention block (one set of attention weights reused at several depths)."""
    attn_every: int = 6        # apply the shared attention block every k layers
    shared_attn: bool = True   # single shared weight set (Zamba2)


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder."""
    n_enc_layers: int = 4
    n_audio_frames: int = 1500   # encoder sequence length (stub conv frontend)


@dataclass(frozen=True)
class VLMConfig:
    n_img_tokens: int = 256      # patch embeddings emitted by the stub ViT


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 => d_model // n_heads
    norm: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"           # silu (swiglu) | gelu | relu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # 0 => full attention
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_bits: int = 16           # 8 => int8 KV cache (per-token scales)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    source: str = ""            # citation for the config values
    notes: str = ""

    # ---- derived ---------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True when decode cost/memory does not grow with full context length
        (SSM / hybrid state, or bounded sliding-window attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs are decoders or enc-dec

    def vocab_padded(self, multiple: int = 256) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Total parameter count (all experts counted)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        return _param_count(self, active_only=True)

    def scaled(self, **kw) -> "ModelConfig":
        """Return a reduced/modified copy (used by smoke tests)."""
        return dataclasses.replace(self, **kw)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    dm, dh = cfg.d_model, cfg.d_head
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    V = cfg.vocab

    def attn_params() -> int:
        return dm * (nh * dh) + 2 * dm * (nkv * dh) + (nh * dh) * dm

    def ffn_params(d_ff: int) -> int:
        if cfg.act == "silu":      # gated: w1, w3 up + w2 down
            return 3 * dm * d_ff
        return 2 * dm * d_ff

    if cfg.family == "ssm" and cfg.xlstm is not None:
        # xLSTM: per-block in/out projections + cell weights (kept consistent
        # with the actual init in models/xlstm.py).
        d_in = int(cfg.xlstm.proj_factor_mlstm * dm)
        per_mlstm = 2 * dm * d_in + d_in * dm + 3 * d_in * d_in + 2 * d_in
        d_s = dm
        per_slstm = 4 * dm * d_s + 4 * d_s * d_s + int(cfg.xlstm.proj_factor_slstm * dm) * dm * 2
        n_s = cfg.n_layers // cfg.xlstm.slstm_every
        n_m = cfg.n_layers - n_s
        body = n_m * per_mlstm + n_s * per_slstm
    elif cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm.expand * dm
        nheads = d_inner // cfg.ssm.head_dim
        per_mamba = (dm * (2 * d_inner + 2 * cfg.ssm.d_state + nheads)
                     + d_inner * dm + cfg.ssm.conv_width * (d_inner + 2 * cfg.ssm.d_state)
                     + 2 * nheads)
        if cfg.family == "hybrid" and cfg.hybrid is not None:
            n_attn_sites = cfg.n_layers // cfg.hybrid.attn_every
            attn_sets = 1 if cfg.hybrid.shared_attn else n_attn_sites
            body = cfg.n_layers * per_mamba + attn_sets * (attn_params() + ffn_params(cfg.d_ff))
        else:
            body = cfg.n_layers * per_mamba
    else:
        if cfg.is_moe:
            e = cfg.moe.top_k if active_only else cfg.moe.n_experts
            per_layer = attn_params() + e * ffn_params(cfg.d_ff) + dm * cfg.moe.n_experts
        else:
            per_layer = attn_params() + ffn_params(cfg.d_ff)
        body = cfg.n_layers * per_layer
        if cfg.family == "audio" and cfg.encdec is not None:
            enc_per = attn_params() + ffn_params(cfg.d_ff)
            dec_cross = attn_params()
            body = (cfg.encdec.n_enc_layers * enc_per
                    + cfg.n_layers * (per_layer + dec_cross))
    embed = V * dm * (1 if cfg.tie_embeddings else 2)
    return body + embed


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: Dict[str, ModelConfig] = {}
# the configs this package carries: the paper's own models plus olmo-1b
# (the dense family's nonparam_ln + silu variant)
_ARCHS = ("bloom-3b", "bloom-7b1", "opt-13b", "olmo-1b")
_CONFIG_MODULES = [a.replace("-", "_").replace(".", "_") for a in _ARCHS]


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCH_REGISTRY[cfg.arch_id] = cfg
    return cfg


def _ensure_loaded() -> None:
    if len(_ARCH_REGISTRY) >= len(_CONFIG_MODULES):
        return
    for mod in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[arch_id]

"""Configuration system of the PyTorch port (a copy of ``repro.config``).

Frozen dataclasses describing model architectures, input shapes, meshes,
hardware and quantization.  Every carried architecture registers a
``ModelConfig`` via :func:`register_arch`; lookup is by the canonical
(dash-separated) id, e.g. ``get_arch("bloom-3b")``.  Besides the JAX
package's TPU record ``V5E``, ``H100`` describes the card the port runs on.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
    n_groups: int = 1          # B/C groups (Mamba2's ngroups): heads
                               # [g H/G, (g+1) H/G) read group g
    conv_bias: bool = False    # the depthwise conv adds a bias


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8       # every k-th block is an sLSTM block, rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention blocks (one
    weight set reused at several depths).

    The defaults are the JAX package's simplification: one block with its
    own residuals applied after every ``attn_every`` Mamba2 layers.  A
    non-empty ``sites`` is the published Zamba2 layout: site i runs block
    ``i % HYBRID_BLOCKS`` on RMSNorm(concat(x, embedding)) with no
    residual inside it, its logits scaled by (d_head / 2)^-1/2, adds the
    site's own LoRA adapter of rank ``adapter_rank`` to its MLP's gate/up
    projection and maps its output through the site's own D -> D linear;
    the result is added to the input of Mamba2 layer ``sites[i]`` (before
    that layer's norm), not to the residual stream."""
    attn_every: int = 6        # apply the shared attention block every k layers
    shared_attn: bool = True   # single shared weight set (Zamba2)
    sites: Tuple[int, ...] = ()  # Mamba2 layers whose input takes a site
    adapter_rank: int = 128    # the per-site LoRA's rank (published layout)


# the published layout's shared weight sets, used in turn (ABAB)
HYBRID_BLOCKS = 2


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
    act: str = "silu"           # silu (swiglu) | gelu | relu | geglu (erf)
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
        if cfg.act in ("silu", "geglu"):   # gated: w1, w3 up + w2 down
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
        if cfg.family == "hybrid" and cfg.hybrid is not None \
                and cfg.hybrid.sites:
            hy, d_in = cfg.hybrid, hybrid_attn_width(cfg)
            G = cfg.ssm.n_groups
            # the groups' B/C, the conv bias, dt_bias, the gate and pre norms
            per_mamba += (2 * (G - 1) * cfg.ssm.d_state * (dm + cfg.ssm.conv_width)
                          + (d_inner + 2 * G * cfg.ssm.d_state) * cfg.ssm.conv_bias
                          + nheads + d_inner + dm)
            block = (d_in * 3 * nh * dh + nh * dh * dm + ffn_params(cfg.d_ff)
                     + d_in + dm)                # q, k, v, o, MLP, 2 norms
            site = hy.adapter_rank * (dm + 2 * cfg.d_ff) + dm * dm
            body = (cfg.n_layers * per_mamba + HYBRID_BLOCKS * block
                    + len(hy.sites) * site + dm)  # + the final norm
        elif cfg.family == "hybrid" and cfg.hybrid is not None:
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


def hybrid_attn_width(cfg: ModelConfig) -> int:
    """The shared block's attention input width: 2 d_model over the
    published layout's concatenated embedding, else d_model."""
    return cfg.d_model * (2 if cfg.hybrid is not None
                          and cfg.hybrid.sites else 1)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / hardware
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip constants read by the roofline and the serving cost model.

    ``ici_bw`` is the chip-to-chip rate a collective's bytes are divided
    by.  For ``V5E`` (the JAX package's TPU v5e defaults) it is one ICI
    link.  For ``H100`` it is one GPU's NVLink 4 rate in one direction,
    which holds inside one node of 8 GPUs: a model axis wider than 8
    crosses the node boundary, where the NIC (about 50 GB/s a GPU on NDR
    InfiniBand) bounds a collective, so ``t_collective`` is then a lower
    bound."""
    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link
    hbm_bytes: float = 16 * 2**30    # per chip


V5E = HardwareSpec()

# NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's H100 datasheet: 989 TFLOP/s
# bf16 dense (the datasheet's 1979 is with 2:4 sparsity), 3.35 TB/s HBM3,
# 900 GB/s NVLink 4 a GPU in both directions (450e9 in one).  hbm_bytes is
# the capacity the card reports: torch.cuda.get_device_properties(0)
# .total_memory = 85,017,493,504 B (79.18 GiB) on an "NVIDIA H100 80GB
# HBM3, 700.00 W" under torch 2.11 (chip_smoke.py phase 11 (a), which
# holds the record within 1 % of the card).
H100 = HardwareSpec(name="h100-sxm5-80gb", peak_flops=989e12,
                    hbm_bw=3.35e12, ici_bw=450e9,
                    hbm_bytes=85_017_493_504)
# int8 dense tensor-core peak of the same card (datasheet: 1979 TOPS); the
# record has no field for it
H100_INT8_OPS = 1979e12


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantConfig:
    """Post-training quantization description (paper §II-B.3).

    ``alpha`` scales memory, ``beta`` scales compute time, ``dppl`` is the
    perplexity differential (per model, from offline calibration — the paper's
    Table II values are the defaults in ``core/quantization.py``).
    """
    name: str = "W16A16"
    weight_bits: int = 16
    act_bits: int = 16
    method: str = "none"       # none | gptq | zq-local | rtn


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: Dict[str, ModelConfig] = {}
# the configs this package carries: the paper's own models, olmo-1b (the
# dense family's nonparam_ln + silu variant), the transformer family's
# other members (GQA, qk-norm, sliding window, MoE, VLM) and the recurrent,
# hybrid and audio families (xLSTM, Zamba2, Whisper): all 13 of the JAX
# package's
_ARCHS = ("bloom-3b", "bloom-7b1", "opt-13b", "olmo-1b",
          "deepseek-coder-33b", "mistral-large-123b", "qwen3-1.7b",
          "mixtral-8x22b", "granite-moe-1b-a400m", "internvl2-26b",
          "xlstm-1.3b", "zamba2-7b", "whisper-tiny")
# configs of the port alone, not of the JAX package: the published
# Zamba2-7B-Instruct block (the JAX package carries its simplification,
# zamba2-7b)
_PORT_ARCHS = ("zamba2-7b-instruct",)
_CONFIG_MODULES = [a.replace("-", "_").replace(".", "_")
                   for a in _ARCHS + _PORT_ARCHS]
# the ten architectures the dry run covers (the JAX package's assigned set)
_ASSIGNED_ARCHS = (
    "xlstm-1.3b", "mistral-large-123b", "internvl2-26b", "olmo-1b",
    "whisper-tiny", "mixtral-8x22b", "deepseek-coder-33b", "zamba2-7b",
    "granite-moe-1b-a400m", "qwen3-1.7b",
)


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


def list_archs(assigned_only: bool = False) -> Tuple[str, ...]:
    _ensure_loaded()
    if assigned_only:
        return _ASSIGNED_ARCHS
    return tuple(sorted(_ARCH_REGISTRY))


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the 4 assigned input shapes run for this arch.

    long_500k requires sub-quadratic decode (SSM/hybrid state or sliding
    window); pure full-attention archs skip it (DESIGN.md §4).
    """
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return tuple(out)

"""Edge-node environment: hardware + wireless + epoch protocol constants."""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.config import H100, ModelConfig, V5E, get_arch
from repro_torch.core.costmodel import CostModel
from repro_torch.core.quantization import QuantMethod, get_method


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) / 1000.0


@dataclass(frozen=True)
class EdgeEnv:
    """Everything the scheduler needs to evaluate P1's constraints."""
    model: ModelConfig
    quant: QuantMethod
    # compute/memory (aggregate over the edge server's accelerators)
    C: float                    # FLOP/s
    M: float                    # bytes
    n_units: int                # independent accelerators (NoB baseline)
    # wireless
    B_U: float = 20e6           # uplink bandwidth (Hz)
    B_D: float = 20e6
    p_u: float = dbm_to_watt(20.0)    # user->EN transmit power (W)
    p_d: float = dbm_to_watt(43.0)    # EN->user
    N0: float = dbm_to_watt(-174.0)   # noise PSD (W/Hz)
    # epoch protocol
    T_E: float = 2.0
    T_U: float = 0.25
    T_D: float = 0.25
    s_max: int = 512            # s': prompts padded to this for batching
    paper_faithful: bool = False

    @property
    def T_C(self) -> float:
        """Compute slot: T_C overlaps the adjacent comm slots (Fig. 2)."""
        return self.T_E

    def cost_model(self) -> CostModel:
        return CostModel(self.model, paper_faithful=self.paper_faithful)

    def with_(self, **kw) -> "EdgeEnv":
        return replace(self, **kw)


def paper_env(model: str = "bloom-3b", quant: str = "W8A16",
              **kw) -> EdgeEnv:
    """The paper's §IV testbed: 20x Jetson TX2 (1.33 TFLOPs, 32 GB each)."""
    defaults = dict(
        model=get_arch(model), quant=get_method(quant),
        C=20 * 1.33e12, M=20 * 32e9, n_units=20, paper_faithful=True)
    defaults.update(kw)
    return EdgeEnv(**defaults)


def tpu_env(model: str, quant: str = "W8A16", chips: int = 16,
            **kw) -> EdgeEnv:
    """TPU v5e edge pod-slice (hardware adaptation, DESIGN.md §3)."""
    defaults = dict(
        model=get_arch(model), quant=get_method(quant),
        C=chips * V5E.peak_flops, M=chips * V5E.hbm_bytes, n_units=chips,
        paper_faithful=False)
    defaults.update(kw)
    return EdgeEnv(**defaults)


def h100_env(model: str, quant: str = "W8A16", chips: int = 1,
             **kw) -> EdgeEnv:
    """The card the port runs on: ``chips`` H100s (bf16 dense peak and the
    memory the card reports, ``config.H100``), priced as ``tpu_env``
    prices its TPU slice."""
    defaults = dict(
        model=get_arch(model), quant=get_method(quant),
        C=chips * H100.peak_flops, M=chips * H100.hbm_bytes, n_units=chips,
        paper_faithful=False)
    defaults.update(kw)
    return EdgeEnv(**defaults)

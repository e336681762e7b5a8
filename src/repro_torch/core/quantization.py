"""Quantization model (paper §II-B.3).

Each PTQ method is characterized by:
  alpha_w / alpha_a — memory scale factors for weights / activations+KV,
  beta            — computational-time scale,
  dppl[model]     — perplexity differential (paper Table II + [10]).

``f_accuracy`` maps dPPL to a service-accuracy score in [0,1]
(monotonically decreasing, as the paper requires); a request is
accuracy-feasible iff a_i <= f(dPPL).

The paper treats alpha as a single factor on (m1 + m2); we keep separate
weight/activation factors (W8A16 does NOT shrink the KV cache) and provide
``alpha`` as the paper-faithful aggregate used by the reproduction benches.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence


@dataclass(frozen=True)
class QuantMethod:
    name: str
    weight_bits: int
    act_bits: int
    beta: float                      # compute-time scale vs FP16
    dppl: Dict[str, float] = field(default_factory=dict)
    dppl_default: float = 0.1
    # measured-coefficient overrides (quant/calibration.py): when set, the
    # analytic bits/16 ratios are replaced by values measured on the real
    # quantized trees / engine, so every P2Coefficients and quant=auto
    # descent runs on the engine that will actually serve the decision.
    # ``beta`` itself is a plain field — measured betas arrive via
    # ``dataclasses.replace`` (see calibration.measured_methods).
    alpha_w_measured: Optional[float] = None
    alpha_a_measured: Optional[float] = None

    @property
    def alpha_w(self) -> float:
        if self.alpha_w_measured is not None:
            return self.alpha_w_measured
        return self.weight_bits / 16.0

    @property
    def alpha_a(self) -> float:
        if self.alpha_a_measured is not None:
            return self.alpha_a_measured
        return self.act_bits / 16.0

    @property
    def serve_bits(self):
        """The engine-facing precision spec: plain weight bits for
        weight-only methods, a ``(weight_bits, act_bits)`` pair when the
        method also quantizes activations (W8A8 -> the int8-accumulation
        kernel tier; see ServingEngine._canon_bits)."""
        if self.act_bits < 16 and self.weight_bits < 16:
            return (self.weight_bits, self.act_bits)
        return self.weight_bits

    @property
    def alpha(self) -> float:
        """Paper-faithful single memory factor (dominated by weights)."""
        return self.alpha_w

    def delta_ppl(self, model: str) -> float:
        return self.dppl.get(model, self.dppl_default)


def f_accuracy(dppl: float) -> float:
    """Monotonically decreasing accuracy score of the PPL differential."""
    return math.exp(-dppl)


# Paper Table II + [10] calibration.  W8A16 is the paper's default.
_TABLE2_GPTQ = {"bloom-3b": 0.75, "bloom-7b1": 0.54, "opt-13b": 0.2}
_TABLE2_ZQL = {"bloom-3b": 0.92, "bloom-7b1": 0.59, "opt-13b": 0.42}

METHODS: Dict[str, QuantMethod] = {
    "W16A16": QuantMethod("W16A16", 16, 16, beta=1.0, dppl_default=0.0),
    "W8A16": QuantMethod("W8A16", 8, 16, beta=0.85, dppl_default=0.05,
                         dppl={"bloom-3b": 0.05, "bloom-7b1": 0.04,
                               "opt-13b": 0.03}),
    "W8A8": QuantMethod("W8A8", 8, 8, beta=0.7, dppl_default=0.15),
    "W4A16-GPTQ": QuantMethod("W4A16-GPTQ", 4, 16, beta=0.8,
                              dppl=_TABLE2_GPTQ, dppl_default=0.6),
    "W4A16-ZQL": QuantMethod("W4A16-ZQL", 4, 16, beta=0.75,
                             dppl=_TABLE2_ZQL, dppl_default=0.7),
}


def get_method(name: str) -> QuantMethod:
    return METHODS[name]


def swap_seconds(record: Optional[Dict], m_from: Optional[QuantMethod],
                 m_to: Optional[QuantMethod]) -> float:
    """Weight-swap latency (seconds) charged when an epoch re-serves from
    ``m_from``'s to ``m_to``'s weight residency, looked up in a
    ``quant/calibration.measure_swap_cost`` record.

    Methods sharing a canonical serving precision (the record's
    ``methods`` map — e.g. W8A16 and W8A8 both canonicalize to int8
    weights on interpret backends) swap for free; unmeasured transitions
    fall back to the record's ``default_s`` (the worst measured pair).
    ``record=None`` charges nothing — the Table-II reproduction has no
    swap model, so un-calibrated schedulers keep the historical pricing.
    """
    if record is None or m_from is None or m_to is None:
        return 0.0
    names = record.get("methods", {})
    a = names.get(getattr(m_from, "name", m_from))
    b = names.get(getattr(m_to, "name", m_to))
    if a is None or b is None:
        return float(record.get("default_s", 0.0))
    if a == b:
        return 0.0
    pair = record.get("pairs", {}).get(f"{a}->{b}")
    if pair is None:
        return float(record.get("default_s", 0.0))
    return float(pair["swap_s"])


# ---------------------------------------------------------------------------
# Method selection (quantization as a scheduling decision)
# ---------------------------------------------------------------------------


def dominates(a: QuantMethod, b: QuantMethod, model: str) -> bool:
    """``a`` dominates ``b`` iff it is no worse on every P1-relevant axis
    (alpha_w, alpha_a, beta, dPPL) and strictly better on at least one.
    Any batch feasible under ``b`` is then feasible under ``a`` (smaller
    memory factors, faster compute, superset accuracy pool)."""
    keys_a = (a.alpha_w, a.alpha_a, a.beta, a.delta_ppl(model))
    keys_b = (b.alpha_w, b.alpha_a, b.beta, b.delta_ppl(model))
    return all(x <= y for x, y in zip(keys_a, keys_b)) and keys_a != keys_b


def pareto_methods(methods: Iterable[QuantMethod],
                   model: str) -> List[QuantMethod]:
    """Drop Pareto-dominated methods (dominated methods can never yield a
    larger feasible batch, so pruning them preserves optimality)."""
    pool = list(methods)
    return [m for m in pool
            if not any(dominates(o, m, model) for o in pool if o is not m)]


def candidate_methods(model: str,
                      accuracies: Optional[Sequence[float]] = None,
                      methods: Optional[Iterable[QuantMethod]] = None
                      ) -> List[QuantMethod]:
    """Candidate set for per-epoch method selection over ``model``:
    prefilter by the batch's accuracy requirements (keep a method only if
    it can serve at least one requested ``a_i <= f(dPPL)``), then drop
    Pareto-dominated methods.  Deterministic order: fastest first
    (beta, then dPPL, alpha_w, name) so a first feasible hit at a given
    batch size is also the preferred method."""
    pool = list(methods) if methods is not None else list(METHODS.values())
    if accuracies is not None:
        pool = [m for m in pool
                if any(a <= f_accuracy(m.delta_ppl(model)) + 1e-12
                       for a in accuracies)]
    pool = pareto_methods(pool, model)
    return sorted(pool, key=lambda m: (m.beta, m.delta_ppl(model),
                                       m.alpha_w, m.name))

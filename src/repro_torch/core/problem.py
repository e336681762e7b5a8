"""Problem P1 / P2 (paper §II-C, §III-A): constraint oracles and the
k-coefficient reformulation.

P1:  max |S|  s.t.
  (1a) sum rho_min_up  <= 1         (1b) sum rho_min_down <= 1
  (1c) alpha (m1 + m2_I + m2_A) <= M
  (1d) t_w,i + T_U + beta (t_I + t_A) + T_D <= tau_i   for all i in S
  (1e) a_i <= f(dPPL)

Every oracle takes an explicit ``quant`` (the method the control plane
decided for this batch); ``quant=None`` falls back to the environment's
deployed method, which keeps fixed-method callers bit-identical.  This is
what lets DFTSP treat the quantization method as a decision variable
instead of a frozen deployment constant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core import comm
from repro_torch.core.environment import EdgeEnv
from repro_torch.core.quantization import QuantMethod, f_accuracy
from repro_torch.core.request import Request


def accuracy_feasible(env: EdgeEnv, r: Request,
                      quant: Optional[QuantMethod] = None) -> bool:
    q = quant or env.quant
    return r.a <= f_accuracy(q.delta_ppl(env.model.arch_id)) + 1e-12


def filter_accuracy(env: EdgeEnv, reqs: Sequence[Request],
                    quant: Optional[QuantMethod] = None) -> List[Request]:
    """The paper's I-tilde: requests satisfied with the quantized model."""
    return [r for r in reqs if accuracy_feasible(env, r, quant)]


def memory_used(env: EdgeEnv, reqs: Sequence[Request],
                quant: Optional[QuantMethod] = None) -> float:
    cm = env.cost_model()
    q = quant or env.quant
    m1 = cm.weight_bytes()
    m2i = cm.kv_bytes_prefill(env.s_max, len(reqs))
    m2a = cm.kv_bytes_decode([r.n for r in reqs], env.s_max)
    return q.alpha_w * m1 + q.alpha_a * (m2i + m2a)


def memory_feasible(env: EdgeEnv, reqs: Sequence[Request],
                    quant: Optional[QuantMethod] = None) -> bool:
    return memory_used(env, reqs, quant) <= env.M + 1e-6


def batch_compute_time(env: EdgeEnv, reqs: Sequence[Request],
                       quant: Optional[QuantMethod] = None) -> float:
    """beta (t_I + t_A) for the whole batch (paper's aggregate-FLOPs model)."""
    cm = env.cost_model()
    q = quant or env.quant
    t_i = cm.t_prefill(env.s_max, len(reqs), env.C)
    t_a = cm.t_decode(env.s_max, [r.n for r in reqs], env.C)
    return q.beta * (t_i + t_a)


def latency_feasible(env: EdgeEnv, reqs: Sequence[Request],
                     t_compute: Optional[float] = None,
                     quant: Optional[QuantMethod] = None,
                     t_extra: float = 0.0) -> bool:
    """(1d): every scheduled request meets its deadline.

    ``t_extra`` is serial epoch time spent BEFORE this batch computes —
    an earlier sub-batch's compute plus the weight-swap latency when the
    epoch's queue is split across quantization methods (DESIGN.md §1.1).
    The default 0.0 is the paper's one-batch-per-epoch accounting.
    """
    if not reqs:
        return True
    if t_compute is None:
        t_compute = batch_compute_time(env, reqs, quant)
    slack = min(r.tau - r.t_w for r in reqs)
    return env.T_U + t_extra + t_compute + env.T_D <= slack + 1e-12


def feasible(env: EdgeEnv, reqs: Sequence[Request],
             check_accuracy: bool = True,
             quant: Optional[QuantMethod] = None) -> bool:
    """Full P1 feasibility of a candidate batch (constraints 1a-1e)."""
    if check_accuracy and not all(accuracy_feasible(env, r, quant)
                                  for r in reqs):
        return False
    return (comm.uplink_feasible(env, reqs)
            and comm.downlink_feasible(env, reqs)
            and memory_feasible(env, reqs, quant)
            and latency_feasible(env, reqs, quant=quant))


def split_feasible(env: EdgeEnv,
                   subs: Sequence[tuple],
                   swap_record: Optional[dict] = None,
                   t_extra: float = 0.0,
                   rho_u0: float = 0.0, rho_d0: float = 0.0) -> bool:
    """P1 feasibility of a SPLIT epoch: ``subs`` is a sequence of
    ``(batch, quant)`` sub-batches served sequentially within one epoch,
    each at its own quantization method (DESIGN.md §1.1).

    * comm (1a/1b) is joint — every sub-batch's transfers share the
      epoch's OFDMA budget (``rho_*0`` lets multi-LLM callers charge
      spectrum other models already hold);
    * accuracy (1e) and memory (1c) are per-sub-batch at its OWN method —
      sub-batches execute back to back, so a sub-batch's KV is released
      before the next one allocates (peak, not sum);
    * latency (1d) is serial: sub-batch j waits through every earlier
      sub-batch's compute plus the measured weight-swap latency between
      consecutive methods (``quantization.swap_seconds``; ``t_extra``
      seats the whole split behind already-queued compute).
    """
    from repro_torch.core.quantization import swap_seconds
    subs = [(list(b), q) for b, q in subs if b]
    flat = [r for b, _ in subs for r in b]
    if not flat:
        return True
    rho_u = rho_u0 + sum(comm.rho_min_up(env, r) for r in flat)
    rho_d = rho_d0 + sum(comm.rho_min_down(env, r) for r in flat)
    if rho_u > 1.0 + 1e-9 or rho_d > 1.0 + 1e-9:
        return False
    t_ahead = t_extra
    prev_q = None
    for batch, q in subs:
        if not all(accuracy_feasible(env, r, q) for r in batch):
            return False
        if not memory_feasible(env, batch, q):
            return False
        if prev_q is not None:
            t_ahead += swap_seconds(swap_record, prev_q, q)
        if not latency_feasible(env, batch, quant=q, t_extra=t_ahead):
            return False
        t_ahead += batch_compute_time(env, batch, quant=q)
        prev_q = q
    return True


# ---------------------------------------------------------------------------
# P2 k-coefficients (paper §III-A) — used by DFTSP's sort keys and by tests
# that verify the reformulation matches the direct constraint oracles.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class P2Coefficients:
    """tau_tilde_i = (tau_i - t_w,i - T_U - T_D - extra_s) * C / beta - k3 z ;
    M_tilde = k2 - s' z  (in KV-token units).

    ``extra_s`` is the swap-cost term of the split-epoch extension: serial
    seconds already spent in this epoch before this batch's compute starts
    (earlier differently-quantized sub-batches plus the measured weight-swap
    latency between their methods).  It enters the slack the same way T_U
    does — every request in this sub-batch waits through it — so the
    slack ranking and the descent's bounds price splits consistently with
    the authoritative oracle (``latency_feasible(..., t_extra=extra_s)``).
    """
    env: EdgeEnv
    quant: Optional[QuantMethod] = None
    extra_s: float = 0.0

    @property
    def q(self) -> QuantMethod:
        return self.quant or self.env.quant

    def tau_tilde(self, r: Request, z: int) -> float:
        """Latency slack in FLOP units, net of the per-request prefill cost
        (k3 = prefill FLOPs per prompt)."""
        env = self.env
        cm = env.cost_model()
        k3 = cm.prefill_flops(env.s_max, 1)
        slack_flops = ((r.tau - r.t_w - env.T_U - env.T_D - self.extra_s)
                       * env.C / self.q.beta)
        return slack_flops - k3 * z

    def decode_cost(self, r: Request) -> float:
        """k4 n + k5 n^2 equivalent: this request's decode FLOPs."""
        return self.env.cost_model().decode_flops(self.env.s_max, [r.n])

    def memory_budget_tokens(self, z: int) -> float:
        """M_tilde: KV-token capacity left after weights + z prefill caches."""
        env = self.env
        cm = env.cost_model()
        q = self.q
        per_tok = cm._kv_bytes_per_token() * q.alpha_a
        if per_tok <= 0:
            return float("inf")
        left = (env.M - q.alpha_w * cm.weight_bytes()
                - q.alpha_a * cm.kv_bytes_prefill(env.s_max, 1) * z)
        return left / per_tok

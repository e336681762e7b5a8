"""Multi-LLM edge node (paper §II: "while Fig. 1 focuses on one LLM, our
approach is adaptable for multiple LLMs").

The EN hosts M quantized models sharing one memory pool, one compute
budget and one OFDMA spectrum; each request targets a model via the
``Request.model_id`` field (``tag`` is a convenience).  Within an epoch the
scheduled batches execute sequentially in a fixed model order, so a
request's latency includes every earlier model's batch compute (faithful
to the single-compute-slot protocol of Fig. 2).

``multi_dftsp`` schedules jointly: models are visited in a configurable
order (cheapest-weights first by default) and each runs the paper's DFTSP against the
RESIDUAL budgets (memory already committed by earlier models, bandwidth
fractions consumed, compute time already queued).  This is a
beyond-paper heuristic — per-model DFTSP is optimal for its residual
subproblem, but the joint selection is not proven optimal (the joint
problem adds knapsack coupling across models; see EXPERIMENTS.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import comm, problem
from repro_torch.core.dftsp import (SearchStats, dftsp_schedule,
                              dftsp_schedule_auto, dftsp_schedule_split)
from repro_torch.core.environment import EdgeEnv
from repro_torch.core.quantization import QuantMethod, get_method, swap_seconds
from repro_torch.core.request import Request


@dataclass(frozen=True)
class MultiLLMEnv:
    """Shared edge node hosting several (model, quant) deployments."""
    envs: Dict[str, EdgeEnv]          # model_id -> single-model view
    C: float                          # shared compute (FLOP/s)
    M: float                          # shared memory (bytes)

    @classmethod
    def host(cls, envs: Dict[str, EdgeEnv]) -> "MultiLLMEnv":
        any_env = next(iter(envs.values()))
        epochs = {e.T_E for e in envs.values()}
        if len(epochs) > 1:        # one epoch grid drives the whole node
            raise ValueError(f"hosted models disagree on T_E: {epochs}")
        return cls(envs={k: v.with_(C=any_env.C, M=any_env.M)
                         for k, v in envs.items()},
                   C=any_env.C, M=any_env.M)

    @property
    def T_E(self) -> float:
        """Epoch duration shared by every hosted deployment."""
        return next(iter(self.envs.values())).T_E

    def env_for(self, r: Request) -> EdgeEnv | None:
        """Single-model view serving this request (None if untargeted)."""
        return self.envs.get(r.model_id)

    def weight_bytes(self) -> float:
        """Resident weights of every hosted model (always in memory)."""
        return sum(e.quant.alpha_w * e.cost_model().weight_bytes()
                   for e in self.envs.values())


def tag(requests: Sequence[Request], model_id: str) -> List[Request]:
    """Set ``Request.model_id`` on each request (thin compat wrapper)."""
    for r in requests:
        r.model_id = model_id
    return list(requests)


def random_tagger(model_ids: Sequence[str], seed: int = 0):
    """A ``tag_arrivals`` hook assigning each arrival a pseudo-random
    hosted model — the multi-LLM traffic shape of the conservation suite
    and the multi-engine benchmarks.

    The assignment is a pure function of ``(seed, rid)``, NOT a shared
    RNG stream: the epoch runtime tags arrivals per epoch while the
    continuous runtime tags the same stream per segment window, so any
    stateful tagger would hand the two protocols different model splits
    for identical traffic.  Stateless hashing keeps them like-for-like.
    """
    ids = list(model_ids)

    def tag_arrivals(arrivals: Sequence[Request]) -> List[Request]:
        for r in arrivals:
            rng = np.random.default_rng((seed, r.rid))
            r.model_id = ids[int(rng.integers(len(ids)))]
        return list(arrivals)

    return tag_arrivals


def model_order(menv: MultiLLMEnv, order: str = "weight") -> List[str]:
    """Model visit order for the sequential compute slot.

    * ``weight`` — cheapest resident weights first (default: its requests
      lose the least slack to queueing behind other models' compute);
    * ``name``   — deterministic lexicographic order;
    * ``load``   — cheapest per-request decode cost first.
    """
    envs = menv.envs
    if order == "weight":
        return sorted(envs, key=lambda m: envs[m].cost_model().weight_bytes())
    if order == "name":
        return sorted(envs)
    if order == "load":
        return sorted(envs, key=lambda m: envs[m].cost_model()
                      .decode_flops(envs[m].s_max, [envs[m].s_max]))
    raise ValueError(f"unknown model order {order!r} "
                     "(expected weight|name|load)")


def _kv_bytes(env: EdgeEnv, batch: Sequence[Request],
              quant: Optional[QuantMethod] = None) -> float:
    cm = env.cost_model()
    q = quant or env.quant
    return q.alpha_a * (
        cm.kv_bytes_prefill(env.s_max, len(batch))
        + cm.kv_bytes_decode([r.n for r in batch], env.s_max))


def multi_dftsp_assign(menv: MultiLLMEnv, requests: Sequence[Request],
                       order: str = "weight", quant: str = "env"
                       ) -> Tuple[Dict[str, List[Request]],
                                  Dict[str, QuantMethod], SearchStats]:
    """Joint schedule across hosted models on shared budgets, returning
    the per-model quantization assignment alongside the batches.

    ``quant`` is ``"env"`` (each model's deployed method — the historical
    behavior), ``"auto"`` (per-model throughput-optimal method via
    ``dftsp_schedule_auto``), or a METHODS name pinning every model.
    """
    batches, quants, _, stats = multi_dftsp_assign_split(
        menv, requests, order=order, quant=quant, split=False)
    return batches, quants, stats


def multi_dftsp_assign_split(menv: MultiLLMEnv,
                             requests: Sequence[Request],
                             order: str = "weight", quant: str = "env",
                             split: bool = True,
                             swap_record: Optional[dict] = None
                             ) -> Tuple[Dict[str, List[Request]],
                                        Dict[str, QuantMethod],
                                        Dict[str, List[Tuple[List[Request],
                                                             QuantMethod]]],
                                        SearchStats]:
    """``multi_dftsp_assign`` with the split-epoch extension: each hosted
    model's residual-budget DFTSP may split its queue into two
    differently-quantized sub-batches (``dftsp_schedule_split``), with the
    measured weight-swap latency charged in that model's slot of the
    sequential compute queue.  Returns ``(batches, quants, splits, stats)``
    — ``splits[mid]`` present only when that model actually split;
    ``quants[mid]`` is then the primary sub-batch's method.
    """
    stats = SearchStats()
    by_model: Dict[str, List[Request]] = {m: [] for m in menv.envs}
    for r in requests:
        if r.model_id in by_model:
            by_model[r.model_id].append(r)

    visit = model_order(menv, order)

    quants: Dict[str, QuantMethod] = {m: e.quant for m, e in menv.envs.items()}
    splits: Dict[str, List[Tuple[List[Request], QuantMethod]]] = {}
    mem_left = menv.M - menv.weight_bytes()
    if mem_left < 0:
        return {m: [] for m in menv.envs}, quants, splits, stats
    rho_u_left = rho_d_left = 1.0
    t_queued = 0.0
    out: Dict[str, List[Request]] = {}

    for mid in visit:
        env = menv.envs[mid]
        pool = by_model[mid]
        # residual-budget view: memory = own weights + the shared
        # remainder (dftsp's (1c) re-subtracts the own-weight term), and
        # earlier models' batch compute delays this batch exactly like a
        # longer uplink slot (single compute queue, Fig. 2)
        W = env.cost_model().weight_bytes()
        own_w = env.quant.alpha_w * W
        res_env = env.with_(M=own_w + max(mem_left, 0.0),
                            T_U=env.T_U + t_queued)
        subs: List[Tuple[List[Request], QuantMethod]] = []
        if split and quant == "auto":
            subs, st = dftsp_schedule_split(res_env, pool,
                                            swap_record=swap_record)
            sel = [r for b, _ in subs for r in b]
            q_m = subs[0][1] if subs else env.quant
        elif quant == "auto":
            sel, q_m, st = dftsp_schedule_auto(res_env, pool)
        else:
            q_m = env.quant if quant == "env" else get_method(quant)
            sel, st = dftsp_schedule(res_env, pool, quant=q_m)
        quants[mid] = q_m
        stats.nodes_visited += st.nodes_visited
        stats.leaves_checked += st.leaves_checked

        # enforce the SHARED bandwidth budget (dftsp saw a full link)
        kept: List[Request] = []
        for r in sorted(sel, key=lambda r: comm.rho_min_up(env, r)):
            ru, rd = comm.rho_min_up(env, r), comm.rho_min_down(env, r)
            if ru <= rho_u_left and rd <= rho_d_left:
                kept.append(r)
                rho_u_left -= ru
                rho_d_left -= rd

        def _kept_subs() -> List[Tuple[List[Request], QuantMethod]]:
            ids = {r.rid for r in kept}
            return [([r for r in b if r.rid in ids], q)
                    for b, q in subs if any(r.rid in ids for r in b)]

        if subs:
            while kept and not problem.split_feasible(
                    res_env, _kept_subs(), swap_record=swap_record):
                kept.pop()   # shed costliest-uplink member until feasible
            subs = [(b, q) for b, q in _kept_subs() if b]
            kept = [r for b, _ in subs for r in b]
            quants[mid] = q_m = subs[0][1] if subs else env.quant
        else:
            while kept and not problem.latency_feasible(res_env, kept,
                                                        quant=q_m):
                kept.pop()   # shed costliest-uplink member until feasible
        out[mid] = kept
        if len(subs) > 1:
            splits[mid] = subs
        if kept and subs:
            # sequential sub-batches: KV peaks at the largest sub-batch,
            # weight residency at the heaviest sub-method; epoch time adds
            # every sub-batch's compute plus the inter-sub swap latency
            mem_left -= (max(_kv_bytes(env, b, q) for b, q in subs)
                         + (max(q.alpha_w for _, q in subs)
                            - env.quant.alpha_w) * W)
            prev = None
            for b, q in subs:
                if prev is not None:
                    t_queued += swap_seconds(swap_record, prev, q)
                t_queued += problem.batch_compute_time(env, b, quant=q)
                prev = q
        elif kept:
            # KV under the decided method, plus the weight delta if the
            # decision re-quantized this model's residency
            mem_left -= (_kv_bytes(env, kept, q_m)
                         + (q_m.alpha_w - env.quant.alpha_w) * W)
            t_queued += problem.batch_compute_time(env, kept, quant=q_m)
        else:
            quants[mid] = env.quant     # nothing served: keep the default
    stats.z_solved = sum(len(v) for v in out.values())
    return out, quants, splits, stats


def multi_dftsp(menv: MultiLLMEnv, requests: Sequence[Request],
                order: str = "weight"
                ) -> Tuple[Dict[str, List[Request]], SearchStats]:
    """Joint schedule across hosted models on shared budgets (fixed
    deployed methods; see ``multi_dftsp_assign`` for method selection)."""
    batches, _, stats = multi_dftsp_assign(menv, requests, order=order)
    return batches, stats


def multi_feasible(menv: MultiLLMEnv, batches: Dict[str, List[Request]],
                   order: str = "weight",
                   quants: Optional[Dict[str, QuantMethod]] = None,
                   splits: Optional[Dict[str, List[Tuple[List[Request],
                                                         QuantMethod]]]]
                   = None,
                   swap_record: Optional[dict] = None) -> bool:
    """Authoritative feasibility oracle for a joint multi-model schedule:
    shared OFDMA spectrum, shared memory pool, and per-request deadlines
    under the sequential single-compute-slot execution in ``order``.
    ``quants`` evaluates each model's constraints (weight residency, KV
    factors, compute scale, accuracy) under its decided method.

    ``splits`` (the split-epoch extension) overrides a model's single
    method with its ordered ``(sub_batch, method)`` list: accuracy is
    checked per sub-batch at its OWN method, memory at the peak across
    the sequential sub-batches (largest KV footprint, heaviest weight
    residency), and latency serially — a request in sub-batch j waits
    through every earlier model's compute, its own model's earlier
    sub-batches, and the inter-sub weight swaps (``swap_record``).
    """
    quants = quants or {}
    splits = splits or {}

    def q_for(mid: str) -> QuantMethod:
        return quants.get(mid) or menv.envs[mid].quant

    def subs_for(mid: str, batch: List[Request]
                 ) -> List[Tuple[List[Request], QuantMethod]]:
        subs = splits.get(mid)
        return subs if subs else [(batch, q_for(mid))]

    rho_u = rho_d = 0.0
    mem = 0.0
    for m, e in menv.envs.items():
        alphas = [q.alpha_w for _, q in splits.get(m, [])] \
            or [q_for(m).alpha_w]
        mem += max(alphas) * e.cost_model().weight_bytes()
    for mid, batch in batches.items():
        env = menv.envs.get(mid)
        if env is None:
            if batch:              # non-empty batch for an unhosted model
                return False
            continue
        subs = subs_for(mid, batch)
        if sorted(r.rid for b, _ in subs for r in b) != \
                sorted(r.rid for r in batch):
            return False           # splits must partition the flat batch
        for sub, q in subs:
            for r in sub:
                if r.model_id != mid:
                    return False
                if not problem.accuracy_feasible(env, r, q):
                    return False
                rho_u += comm.rho_min_up(env, r)
                rho_d += comm.rho_min_down(env, r)
        if batch:
            mem += max(_kv_bytes(env, sub, q) for sub, q in subs)
    if rho_u > 1.0 + 1e-9 or rho_d > 1.0 + 1e-9:
        return False
    if mem > menv.M + 1e-6:
        return False
    t_queued = 0.0
    for mid in model_order(menv, order):
        batch = batches.get(mid, [])
        if not batch:
            continue
        env = menv.envs[mid]
        prev: Optional[QuantMethod] = None
        for sub, q in subs_for(mid, batch):
            if prev is not None:
                t_queued += swap_seconds(swap_record, prev, q)
            t = problem.batch_compute_time(env, sub, quant=q)
            for r in sub:
                if r.t_w + env.T_U + t_queued + t + env.T_D > r.tau + 1e-9:
                    return False
            t_queued += t
            prev = q
    return True

"""EpochRuntime: THE epoch/queue lifecycle loop (paper Fig. 2 + §IV).

Historically the protocol — arrivals join at the epoch boundary, queued
requests age, hopeless requests drop, a scheduler picks a batch, served
requests leave — was hand-rolled three times (analytic sim, real-engine
serving, multi-LLM benchmarks) with drifting semantics.  It now lives
here exactly once, parameterized on two axes:

  * control plane — a ``SchedulerPolicy`` (core/policy.py): what to batch,
    WITH WHICH QUANTIZATION METHOD (``Decision.quants``), and the
    feasibility oracle the runtime re-checks it against;
  * data plane — an ``Executor``: how a decision is carried out.
    ``AnalyticExecutor`` charges cost-model time only (the paper's
    figures); ``EngineExecutor`` runs each batch on real JAX models via
    ``ServingEngine.generate`` — at the decision's precision, through the
    engine's multi-precision weight cache — clamping to engine capacity
    with a feasibility re-check and spill accounting instead of the old
    silent truncation.

The epoch loop records each epoch's decided method per model in its
``EpochTrace.quants`` and aggregates ``EpochMetrics.served_by_method``,
so adaptive-precision runs are auditable epoch by epoch.  It also times
every ``executor.execute`` call (``EpochTrace.wall_s``, aggregated into
``EpochMetrics.wall_s`` / ``tokens_per_s``) — under ``EngineExecutor``
that is the real data plane's measured decode throughput, since
``ServingEngine.generate`` blocks on its single device→host transfer.  (The historical
``simulate`` / ``serve_epochs`` / ``sweep`` shims are gone; drive this
class directly.)

``ContinuousRuntime`` is the iteration-level sibling: the same queue
lifecycle, but the data plane (a ``ContinuousExecutor``) runs chunked
decode segments and ADMITS queued requests at every segment boundary —
each slot refill gated by ``policy.validate()`` on the joint
resident-plus-candidate batch, so the paper's P1 constraints still hold
for everything on the device.  On a ``MultiLLMEnv`` the executor keeps
one device-resident cohort PER HOSTED ENGINE and every admission is
additionally re-checked against the authoritative joint oracle
(``multi.multi_feasible``) — per-model feasibility does not compose on
shared node budgets, and a policy that pretends it does raises
``InfeasibleDecisionError`` instead of serving.  Each freshly started
cohort picks its quantization method through the policy's
``select_quant`` (the PR-2 ``quant=auto`` descent on the continuous
path), served via the engine's multi-precision weight cache and
recorded in ``EpochTrace.quants``.  See DESIGN.md §2.1/§2.2.

This copy in the PyTorch port carries the epoch half only (``Executor``,
``AnalyticExecutor``, ``EngineExecutor``, ``EpochRuntime``);
``ContinuousRuntime`` and its executors are still to be ported.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.environment import EdgeEnv
from repro_torch.core.metrics import EpochMetrics, EpochTrace
from repro_torch.core.multi import MultiLLMEnv, multi_feasible
from repro_torch.core.policy import (Decision, DrainStallError,
                               InfeasibleDecisionError,
                               SchedulerPolicy, as_policy)
from repro_torch.core.quantization import QuantMethod, candidate_methods
from repro_torch.core.request import Request, RequestGenerator
from repro_torch.serving.faults import TransientStepError

Env = Union[EdgeEnv, MultiLLMEnv]


def still_viable(env: EdgeEnv, r: Request, now: float) -> bool:
    """Could this queued request still meet its deadline if scheduled at the
    *next* epoch boundary?  Lower bound: comm slots + its lone compute at
    its true prompt length (<= any batched/padded execution).

    The bound is computed under the env's deployed method even when a
    policy selects quant per epoch — it is a drop heuristic, and keeping
    it method-independent keeps fixed- and adaptive-method runs on the
    same queue trajectory for like-for-like comparison."""
    t_w = now - r.arrival
    cm = env.cost_model()
    lone = env.quant.beta * (cm.prefill_flops(r.s, 1)
                             + cm.decode_flops(r.s, [r.n])) / env.C
    return t_w + env.T_U + lone + env.T_D <= r.tau + 1e-12


# ---------------------------------------------------------------------------
# Executors: the data plane behind a scheduling decision
# ---------------------------------------------------------------------------


class Executor:
    """How a scheduling decision is carried out each epoch."""

    def admit(self, env: Env, policy: SchedulerPolicy, decision: Decision
              ) -> Tuple[Decision, List[Request]]:
        """Clamp a decision to this data plane's capacity.  Returns the
        (possibly reduced) decision plus the spilled requests, which stay
        in the queue for later epochs."""
        return decision, []

    def execute(self, env: Env, decision: Decision) -> int:
        """Run the decision; returns the number of generated tokens."""
        raise NotImplementedError


class AnalyticExecutor(Executor):
    """Cost-model-time execution: nothing runs, latency/memory are charged
    analytically (P1's constraints).  The paper's evaluation path."""

    def execute(self, env: Env, decision: Decision) -> int:
        return 0


class EngineExecutor(Executor):
    """Real data plane: each batch executes on a ``ServingEngine``
    (batched prefill + decode on the JAX model).

    ``engines`` is one engine (single-model node) or a dict keyed by
    ``model_id`` mirroring a MultiLLMEnv's hosted deployments.  Batches
    larger than an engine's static ``batch_capacity`` are clamped and the
    spill is reported to the runtime (re-queued + counted) — the clamped
    batch is re-validated against the policy's own oracle rather than
    trusted silently.

    When a decision carries a quant assignment, each batch executes at
    that method's weight precision via the engine's multi-precision
    weight cache (``ServingEngine.params_for``) — the decided precision
    actually reaches the Pallas dequant-matmul kernel.
    """

    def __init__(self, engines, rng: Optional[np.random.Generator] = None,
                 seed: int = 0):
        if not isinstance(engines, dict):
            engines = {None: engines}
        self.engines = engines
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    def admit(self, env: Env, policy: SchedulerPolicy, decision: Decision
              ) -> Tuple[Decision, List[Request]]:
        spilled: List[Request] = []
        batches = {}
        for mid, batch in decision.batches.items():
            cap = self.engines[mid].batch_capacity
            batches[mid] = batch[:cap]
            spilled.extend(batch[cap:])
        if not spilled:
            return decision, []
        # A split decision's sub-batch structure must survive the clamp:
        # the flat batch is the concatenation of the sub-batches, so a
        # prefix cut truncates from the LAST sub-batch backwards — kept
        # rows stay in their decided-method group (an entry collapsing
        # to one sub-batch drops back to the flat form; its method is
        # already ``quants[mid]``, the primary).
        splits = {}
        for mid, subs in decision.splits.items():
            kept = {r.rid for r in batches.get(mid, [])}
            subs2 = [([r for r in b if r.rid in kept], q)
                     for b, q in subs]
            subs2 = [(b, q) for b, q in subs2 if b]
            if len(subs2) > 1:
                splits[mid] = subs2
        clamped = Decision(batches=batches, stats=decision.stats,
                           quants=decision.quants, splits=splits)
        # Feasibility is monotone under request removal for every shipped
        # policy, but the oracle is the contract — re-check, don't assume.
        if not policy.validate(env, clamped):
            raise InfeasibleDecisionError(
                f"{policy.spec}: capacity-clamped batch failed its own "
                f"oracle")
        return clamped, spilled

    def execute(self, env: Env, decision: Decision) -> int:
        tokens = 0
        for mid, batch in decision.batches.items():
            if not batch:
                continue
            engine = self.engines[mid]
            subs = decision.splits.get(mid)
            if subs:
                # split epoch (DESIGN.md §1.1): each sub-batch executes
                # back to back at its OWN method — the engine's
                # multi-precision weight cache makes the inter-sub swap
                # a dict lookup (its latency is charged by the control
                # plane's swap-cost term, not re-measured here)
                for sub, q in subs:
                    if not sub:
                        continue
                    prompts, caps = engine.synth_prompts(sub, self.rng)
                    result = engine.generate(
                        prompts, caps,
                        quant_bits=None if q is None else q.serve_bits)
                    tokens += int(result.lengths.sum())
                continue
            prompts, caps = engine.synth_prompts(batch, self.rng)
            q = decision.quants.get(mid)
            result = engine.generate(
                prompts, caps,
                quant_bits=None if q is None else q.serve_bits)
            tokens += int(result.lengths.sum())
        return tokens


# ---------------------------------------------------------------------------
# The one control loop
# ---------------------------------------------------------------------------


class EpochRuntime:
    """Drives the epoch protocol for any (env, policy, executor) triple."""

    def __init__(self, env: Env, policy: Union[str, SchedulerPolicy],
                 executor: Optional[Executor] = None):
        self.env = env
        self.policy = as_policy(policy)
        self.executor = executor or AnalyticExecutor()

    @property
    def T_E(self) -> float:
        return self.env.T_E

    def _env_for(self, r: Request) -> Optional[EdgeEnv]:
        """The single-model constraint view serving this request."""
        if isinstance(self.env, MultiLLMEnv):
            return self.env.env_for(r)
        return self.env

    @staticmethod
    def _resolve_gen(rate: Optional[float], seed: int,
                     gen: Optional[RequestGenerator]) -> RequestGenerator:
        """The ONE default workload (paper §IV marginals) — shared by the
        epoch and continuous loops so their traffic stays comparable."""
        if gen is not None:
            return gen
        if rate is None:
            raise ValueError("provide either rate= or gen=")
        return RequestGenerator(rate=rate, seed=seed,
                                lengths=(128, 256, 512))

    def _age_and_drop(self, queue: List[Request], now: float
                      ) -> Tuple[List[Request], int]:
        """Age every queued request to ``now`` and drop the hopeless (or
        untargeted) ones — the ONE copy of the viability bookkeeping,
        shared by the epoch and continuous loops so their queue
        trajectories cannot drift."""
        viable: List[Request] = []
        dropped = 0
        for r in queue:
            r.t_w = now - r.arrival
            env_r = self._env_for(r)
            if env_r is not None and still_viable(env_r, r, now):
                viable.append(r)
            else:
                dropped += 1
        return viable, dropped

    def run(self, rate: Optional[float] = None, n_epochs: int = 30,
            seed: int = 0, gen: Optional[RequestGenerator] = None,
            warmup_epochs: int = 1,
            tag_arrivals: Optional[Callable[[List[Request]],
                                            List[Request]]] = None
            ) -> EpochMetrics:
        """Run the epoch protocol with Poisson(rate) arrivals.

        The first ``warmup_epochs`` epochs run but are excluded from the
        aggregate metrics (queue fill-up transient).  ``tag_arrivals``
        lets multi-LLM workloads assign each arrival a ``model_id``.
        """
        gen = self._resolve_gen(rate, seed, gen)
        T_E = self.T_E
        m = EpochMetrics(n_epochs=n_epochs, T_E=T_E)
        queue: List[Request] = []

        for e in range(n_epochs + warmup_epochs):
            t0 = e * T_E
            counting = e >= warmup_epochs
            # requests that arrived during the previous epoch join the queue
            arrivals = gen.within(t0 - T_E, t0) if e else []
            if tag_arrivals is not None:
                arrivals = tag_arrivals(arrivals)
            if counting:
                m.arrived += len(arrivals)
            queue.extend(arrivals)

            # age the queue; drop hopeless (or untargeted) requests
            queue, n_dropped = self._age_and_drop(queue, t0)
            if counting:
                m.dropped += n_dropped

            decision = self.policy.schedule(self.env, queue)
            decision, spilled = self.executor.admit(self.env, self.policy,
                                                    decision)
            # authoritative re-check against the policy's own oracle
            # (schedulers must not cheat)
            if not self.policy.validate(self.env, decision):
                raise InfeasibleDecisionError(
                    f"{self.policy.spec} returned an infeasible batch")
            # real executors block on the result (ServingEngine.generate
            # device_gets), so this wall-clock is the data plane's t_A+t_I
            t_exec = time.perf_counter()
            tokens, n_faults = 0, 0
            for attempt in range(4):
                # bounded retry: a TransientStepError is raised BEFORE
                # the data plane mutated anything (serving/faults.py),
                # so replaying the epoch's execute is safe; after the
                # retry budget the epoch proceeds unexecuted (analytic
                # charging is unaffected; the fault is accounted).
                try:
                    tokens = self.executor.execute(self.env, decision)
                    break
                except TransientStepError:
                    n_faults += 1
                    if counting:
                        m.faults_injected += 1
                        if attempt < 3:
                            m.retried += 1
            wall_s = time.perf_counter() - t_exec

            sel = decision.selected
            # the method each served model actually ran with this epoch
            quants = {mid: decision.quant_for(mid, self.env).name
                      for mid, batch in decision.batches.items() if batch}
            if counting:
                m.served += len(sel)
                m.batch_sizes.append(len(sel))
                m.nodes_visited += decision.stats.nodes_visited
                m.leaves_checked += decision.stats.leaves_checked
                m.truncated += len(spilled)
                m.generated_tokens += tokens
                m.wall_s += wall_s
                for mid, batch in decision.batches.items():
                    if batch:
                        # per sub-batch: a split epoch serves one model
                        # at MORE than one precision (identical to the
                        # flat accounting for non-split decisions)
                        for sub, q in decision.sub_batches(mid, self.env):
                            m.served_by_method[q.name] = \
                                m.served_by_method.get(q.name, 0) + len(sub)
                        m.served_by_model[mid] = \
                            m.served_by_model.get(mid, 0) + len(batch)
            m.traces.append(EpochTrace(
                epoch=e, arrived=len(arrivals), dropped=n_dropped,
                selected_rids=[r.rid for r in sel], truncated=len(spilled),
                nodes_visited=decision.stats.nodes_visited,
                generated_tokens=tokens, counted=counting,
                quants=quants, wall_s=wall_s, faults=n_faults))

            chosen = {r.rid for r in sel}
            queue = [r for r in queue if r.rid not in chosen]
        m.final_queue_rids = [r.rid for r in queue]
        return m

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
from repro_torch.serving.slo import (DegradationController, SpillRecord,
                               edf_order, pick_victim)

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


# ---------------------------------------------------------------------------
# Continuous batching: chunked decode segments + mid-epoch admission
# ---------------------------------------------------------------------------


class ContinuousExecutor:
    """Slot-structured data plane behind ``ContinuousRuntime``.

    One POOL of ``capacity`` request slots per hosted model.  Resident
    requests advance ``k`` tokens per ``step`` (one chunked decode
    segment); rows that finish free their slot, and freed slots are
    refillable between segments — the iteration-level batching the
    epoch protocol cannot express.  Subclasses implement the token
    mechanics; this base owns the slot bookkeeping shared by both.
    """

    #: whether ``requant`` changes what the data plane actually SERVES
    #: (precision/speed), not just the bookkeeping.  The analytic plane
    #: emits k tokens per segment regardless of method, so flipping a
    #: live cohort there cannot deliver the loosened admission bound the
    #: oracle would price — the runtime's rising-edge requant skips
    #: planes where the flip is serving-inert.
    requant_effective = False

    def __init__(self):
        self._pools: Dict[Optional[str], dict] = {}
        # rid -> the QuantMethod the request was DECIDED at when placed
        # (split serving, DESIGN.md §1.1): per-row accounting and the
        # engine executor's sub-batch grouping follow this, not just the
        # pool-level cohort method
        self._rid_method: Dict[int, QuantMethod] = {}

    # -- pool construction ---------------------------------------------------

    def bind(self, env: Env) -> None:
        """(Re)build one empty pool per hosted model of ``env``."""
        mids = list(env.envs) if isinstance(env, MultiLLMEnv) else [None]
        self._pools = {mid: self._make_pool(mid) for mid in mids}

    def _make_pool(self, mid: Optional[str]) -> dict:
        return {"capacity": self._capacity(mid), "resident": {},
                "pending": [], "quant": None}

    def _capacity(self, mid: Optional[str]) -> int:
        raise NotImplementedError

    # -- slot bookkeeping (shared) -------------------------------------------

    def pool_ids(self) -> List[Optional[str]]:
        return list(self._pools)

    def resident(self, mid: Optional[str]) -> List[Request]:
        """Requests currently occupying slots (incl. pending refills) —
        the batch an admission candidate must stay jointly feasible
        with."""
        pool = self._pools[mid]
        return list(pool["resident"].values()) \
            + [r for _, r, _, _ in pool["pending"]]

    def free_slots(self, mid: Optional[str]) -> int:
        pool = self._pools[mid]
        return pool["capacity"] - len(pool["resident"]) \
            - len(pool["pending"])

    def accepts(self, mid: Optional[str], r: Request) -> bool:
        """Slot-structure gate only (P1 feasibility is the runtime's
        job, via ``policy.validate``)."""
        return mid in self._pools and self.free_slots(mid) > 0

    def place(self, mid: Optional[str], r: Request,
              resume: Optional[dict] = None,
              quant: Optional[QuantMethod] = None) -> None:
        """Claim the lowest free slot for an admitted request; the refill
        executes at the start of the next ``step`` (engines batch all of
        a boundary's admissions into ONE prefill).  ``resume`` is the
        opaque payload a prior ``preempt`` of this request returned —
        the subclass restores the spilled progress when the refill
        lands.  ``quant`` is the method THIS request was decided at
        (split serving): ``None`` means method-agnostic — the request
        joins whatever the pool's cohort serves at — while a tagged
        request only joins a matching-precision cohort (the engine
        executor holds it until that sub-batch starts)."""
        pool = self._pools[mid]
        taken = set(pool["resident"]) \
            | {s for s, _, _, _ in pool["pending"]}
        slot = min(s for s in range(pool["capacity"]) if s not in taken)
        pool["pending"].append((slot, r, resume, quant))
        if quant is not None:
            self._rid_method[r.rid] = quant

    def evictable(self, mid: Optional[str]) -> List[Request]:
        """Rows preemption may evict: resident ON the data plane.
        Pending refills are excluded — they were admitted this very
        boundary and have not prefilled yet, so evicting them would
        churn admissions without freeing any device state."""
        return list(self._pools[mid]["resident"].values())

    def preempt(self, mid: Optional[str], rid: int) -> dict:
        """Evict the RESIDENT request ``rid`` from its slot at a segment
        boundary, returning the opaque resume payload a later
        ``place(..., resume=)`` restores (DESIGN.md §2.4).  Slot and any
        physical KV are released immediately; the runtime owns the
        re-queue/backoff/attempt bookkeeping."""
        raise NotImplementedError

    def evacuate(self, mid: Optional[str]) -> List[Request]:
        """Empty pool ``mid`` entirely — resident AND pending — and
        return the removed requests.  Quarantine support: the runtime
        sheds (or re-queues) the returned work with explicit accounting;
        the pool is left clean so a later un-quarantine could reuse
        it."""
        raise NotImplementedError

    def idle(self) -> bool:
        return all(not p["resident"] and not p["pending"]
                   for p in self._pools.values())

    def block_usage(self) -> Tuple[int, int, int, int]:
        """KV-block accounting snapshot, recorded by the runtime after
        every segment: ``(blocks_in_use, blocks_total, live_tokens,
        alloc_tokens)``.  Data planes without a physical block pool
        (analytic, slab engines) report slot-level occupancy — one
        "block" per resident request against the node's slot capacity,
        with no token accounting (0, 0).  The arena-backed engine
        executor overrides this with true page counts, and
        ``alloc_tokens - live_tokens`` is the allocated-but-dead volume
        behind ``EpochMetrics.fragmentation``."""
        occupied = sum(len(p["resident"]) for p in self._pools.values())
        capacity = sum(p["capacity"] for p in self._pools.values())
        return occupied, capacity, 0, 0

    def topup_pages(self) -> int:
        """Cumulative pages leased via segment-boundary top-ups
        (DESIGN.md §2.3) — 0 for data planes without incremental
        leasing.  The runtime records the per-run delta as
        ``EpochMetrics.kv_topup_pages``."""
        return 0

    # -- per-cohort quantization lifecycle -----------------------------------

    def set_quant(self, mid: Optional[str],
                  method: Optional[QuantMethod]) -> None:
        """Record the method the cohort STARTING in pool ``mid`` is served
        with (``None`` = the deployment default).  Called by the runtime
        at the first admission into an empty pool; the value sticks for
        the cohort's whole life (refills join at the cohort's precision)
        and is overwritten when the next cohort starts."""
        self._pools[mid]["quant"] = method

    def quant_of(self, mid: Optional[str]) -> Optional[QuantMethod]:
        """The method the pool's current cohort is served with (None =
        deployment default)."""
        return self._pools[mid]["quant"]

    def decided_quant(self, rid: int,
                      default: Optional[QuantMethod] = None
                      ) -> Optional[QuantMethod]:
        """The method request ``rid`` was decided at when placed (split
        serving), else ``default`` — the runtime rebuilds per-model
        sub-batch structure for its trial Decisions from this."""
        return self._rid_method.get(rid, default)

    def requant(self, mid: Optional[str],
                method: Optional[QuantMethod]) -> None:
        """Re-point pool ``mid``'s LIVE cohort at ``method`` mid-flight
        (graceful degradation, DESIGN.md §2.4): the pool's method flips
        and resident rows + pending refills are re-tagged so accounting
        (``method_name``) and sub-batch grouping follow.  Subclasses
        additionally swap the data plane's served precision."""
        pool = self._pools[mid]
        pool["quant"] = method
        for r in pool["resident"].values():
            self._rid_method[r.rid] = method
        pool["pending"] = [(s, r, res, method)
                           for s, r, res, _ in pool["pending"]]
        for _, r, _, _ in pool["pending"]:
            self._rid_method[r.rid] = method

    def arena_blocked(self, mid: Optional[str], r: Request) -> bool:
        """True when admitting ``r`` into ``mid`` is refused by the
        node's PHYSICAL KV budget (the paged arena) even though the pool
        has free slots — the case where preemption must look at OTHER
        pools' residents, since any cohort's released pages free the
        shared arena.  Data planes without a page pool are never
        arena-blocked."""
        return False

    def method_name(self, mid: Optional[str], env_r: EdgeEnv,
                    rid: Optional[int] = None) -> str:
        """Label for ``served_by_method`` accounting: the precision this
        request actually served at — its OWN decided method when it was
        placed with one (split cohorts serve rows at different methods),
        else the pool's cohort method, else the env's deployed method
        (engine subclasses may add engine-level overrides)."""
        q = self._rid_method.get(rid) if rid is not None else None
        if q is None:
            q = self._pools[mid]["quant"]
        return q.name if q is not None else env_r.quant.name

    # -- token mechanics (subclass contract) ---------------------------------

    def tokens_per_epoch(self) -> int:
        """Decode steps one epoch is provisioned for (sets the default
        segment grid: ``segments_per_epoch = ceil(tokens_per_epoch/k)``,
        so chunk size k = tokens_per_epoch reduces to one admission point
        per epoch — the epoch protocol's grid)."""
        raise NotImplementedError

    def step(self, env: Env, k: int
             ) -> Tuple[List[Tuple[Optional[str], Request, int]], float]:
        """Apply pending refills, advance every pool by at most ``k``
        tokens, and return (finished rows as ``(model_id, request,
        generated_tokens)``, mean occupied-slot fraction during the
        segment)."""
        raise NotImplementedError


class AnalyticContinuousExecutor(ContinuousExecutor):
    """Cost-model-time continuous data plane: nothing runs, resident
    requests emit ``k`` tokens per segment and finish after ``n_i`` —
    the deterministic vehicle for the conservation property tests (like
    ``AnalyticExecutor``, it reports 0 generated tokens)."""

    def __init__(self, capacity: Union[int, Dict[Optional[str], int]] = 8,
                 tokens_per_epoch_: int = 512):
        super().__init__()
        self._cap = capacity
        self._tokens_per_epoch = tokens_per_epoch_

    def _make_pool(self, mid):
        pool = super()._make_pool(mid)
        pool["remaining"] = {}          # slot -> output tokens left
        return pool

    def _capacity(self, mid: Optional[str]) -> int:
        return self._cap[mid] if isinstance(self._cap, dict) else self._cap

    def tokens_per_epoch(self) -> int:
        return self._tokens_per_epoch

    def step(self, env, k):
        finished, occupied, capacity = [], 0, 0
        for mid, pool in self._pools.items():
            for slot, r, resume, _ in pool["pending"]:
                pool["resident"][slot] = r
                # a resumed request keeps its spilled progress: only the
                # tokens it had NOT yet emitted remain to be served
                pool["remaining"][slot] = resume["remaining"] \
                    if resume is not None else r.n
            pool["pending"].clear()
            occupied += len(pool["resident"])
            capacity += pool["capacity"]
            for slot, r in list(pool["resident"].items()):
                pool["remaining"][slot] -= k
                if pool["remaining"][slot] <= 0:
                    finished.append((mid, r, 0))
                    del pool["resident"][slot]
                    del pool["remaining"][slot]
        return finished, occupied / capacity if capacity else 0.0

    def preempt(self, mid, rid):
        pool = self._pools[mid]
        slot = next(s for s, r in pool["resident"].items() if r.rid == rid)
        del pool["resident"][slot]
        return {"remaining": pool["remaining"].pop(slot)}

    def evacuate(self, mid):
        pool = self._pools[mid]
        removed = list(pool["resident"].values()) \
            + [r for _, r, _, _ in pool["pending"]]
        pool["resident"].clear()
        pool["remaining"].clear()
        pool["pending"].clear()
        return removed


class EngineContinuousExecutor(ContinuousExecutor):
    """Real continuous data plane: each pool is a ``ServingEngine``
    COHORT driven through the chunked decode API.

    Admissions buffered by ``place`` become ONE prefill at the next
    ``step`` — ``start_chunked`` for an empty pool, ``refill_chunked``
    spliced into the live cohort otherwise.  Each segment is one jitted
    ``generate_chunked`` call plus one small ``poll_chunked`` readback
    (the per-segment host sync that buys the admission point).  A row
    finishes when EOS fires or its cap fills; when a cohort drains (or
    its shared cache position exhausts at ``n_max``) the pool resets and
    the next admission starts a fresh cohort.  ``accepts`` additionally
    requires the cohort headroom to cover a candidate's full clamped
    service ``min(n_i, n_max)`` so refills are never silently truncated.

    ``engines`` is one engine or a ``{model_id: ServingEngine}`` dict
    keyed like the hosted ``MultiLLMEnv`` (mirroring ``EngineExecutor``)
    — ONE device-resident cohort per hosted engine, all advancing on the
    node's shared segment grid.  Refill caps are clamped to the target
    cohort's OWN remaining headroom (``node_headroom``); cross-cohort
    memory pressure is expressed through the paged KV ``arena`` when one
    is attached — each admission must reserve its cap-aware pages (its
    own ``t + n`` span, not a worst-case slab stripe) from
    the node-wide pool, and pages released by ANY cohort's completed
    rows are immediately allocatable by every other (the historical
    min-headroom clamp that let one long-running cohort throttle every
    model's admission is gone; DESIGN.md §2.3).

    Each cohort's served precision is the runtime-decided method
    (``set_quant``, from ``policy.select_quant`` at cohort start) via
    the engine's multi-precision weight cache; ``quant_bits`` optionally
    pins an engine-level fallback for cohorts with no decided method —
    an override, not a scheduled method, so ``served_by_method`` records
    it as ``"weight_bits=<b>"`` rather than borrowing a METHODS name
    whose beta/accuracy terms were never applied.
    """

    # a mid-flight requant re-points the live DecodeState at another
    # entry of the multi-precision weight cache: the very next segment
    # really does serve at the new precision
    requant_effective = True

    def __init__(self, engines, rng: Optional[np.random.Generator] = None,
                 seed: int = 0, quant_bits: Optional[int] = None,
                 collect_tokens: bool = False, arena=None):
        super().__init__()
        if not isinstance(engines, dict):
            engines = {None: engines}
        self.engines = engines
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.quant_bits = quant_bits
        # node-wide paged KV arena (serving/kv_arena.py): pools whose
        # engine can serve paged run arena-backed cohorts, admission
        # gated by page reservation instead of the min-headroom clamp
        self.arena = arena
        self._pending_pages = 0
        # rid -> generated token ids, filled at completion when enabled
        # (one full poll per segment instead of the light occupancy poll
        # — equivalence tests only; leave off on the hot path)
        self.collect_tokens = collect_tokens
        self.outputs: Dict[int, np.ndarray] = {}

    def _make_pool(self, mid):
        if mid not in self.engines:
            raise KeyError(
                f"no ServingEngine bound for hosted model {mid!r}; "
                f"executor hosts {sorted(map(str, self.engines))}")
        pool = super()._make_pool(mid)
        eng = self.engines[mid]
        paged = self.arena is not None and eng.paged_capable \
            and eng.cache_len % self.arena.block_tokens == 0
        # prompts: slot -> synthesized prompt of the resident row.  Kept
        # because preemption resume must re-prefill the IDENTICAL prompt
        # (synthesis is rng-driven and unrepeatable) — dropped again the
        # moment the row finishes.
        pool.update(engine=eng, state=None, t=0, paged=paged, prompts={})
        return pool

    def _capacity(self, mid) -> int:
        return self.engines[mid].batch_capacity

    def tokens_per_epoch(self) -> int:
        return max(e.n_max for e in self.engines.values())

    def method_name(self, mid, env_r: EdgeEnv,
                    rid: Optional[int] = None) -> str:
        q = self._rid_method.get(rid) if rid is not None else None
        if q is None:
            q = self._pools[mid]["quant"]
        if q is not None:
            return q.name
        if self.quant_bits is None:
            return env_r.quant.name
        return f"weight_bits={self.quant_bits}"

    def _cohort_bits(self, pool):
        """Precision spec a starting cohort is served at: the decided
        method's ``serve_bits`` (an int, or a (w, a) pair for W8A8 —
        routed to the engine's int8-activation tier), else the
        engine-level override, else None (the engine default)."""
        q = pool["quant"]
        return q.serve_bits if q is not None else self.quant_bits

    def node_headroom(self, mid) -> int:
        """Output tokens a refill into ``mid`` can be promised: the
        target pool's OWN cohort headroom (``n_max`` for a fresh
        cohort).  Historically this was clamped to the MINIMUM headroom
        across every live cohort on the node — a blunt provisioning
        proxy under which one long-running cohort throttled every
        model's admission.  The paged arena replaced that proxy with
        true per-block accounting: cross-cohort memory pressure is now
        expressed as page reservations (``accepts`` asks the arena
        whether the candidate's worst-case pages fit), and the paper's
        joint constraints stay with the authoritative ``multi_feasible``
        oracle at admission — so another cohort's AGE no longer caps
        this cohort's refill promises (DESIGN.md §2.3)."""
        pool = self._pools[mid]
        eng = self.engines[mid]
        return eng.n_max if pool["state"] is None \
            else eng.headroom(pool["t"])

    def _pages_needed(self, mid, r) -> int:
        """Cap-aware arena pages admitting ``r`` into ``mid`` reserves
        at the next boundary (0 for slab pools): the pages the row will
        lease over its WHOLE life given its own cap ``min(n, n_max)`` at
        the pool's current cohort step — initial prompt+first-write
        lease plus every future segment-boundary top-up — not the
        historical worst-case span to the end of the cache."""
        pool = self._pools[mid]
        if not pool.get("paged"):
            return 0
        eng = pool["engine"]
        t = 0 if pool["state"] is None else pool["t"]
        return eng.pages_for_admission(t, min(int(r.n), eng.n_max),
                                       self.arena.block_tokens)

    def _outstanding_pages(self) -> int:
        """Pages live paged cohorts are still entitled to lease via
        future top-ups (Σ ``lease_last - lease_end`` over resident
        rows).  Charged against admission BEFORE this boundary's refills
        land, so incremental top-ups can never race a fresh admission
        into :class:`ArenaExhausted`."""
        total = 0
        for pool in self._pools.values():
            if pool.get("paged") and pool["state"] is not None:
                total += pool["engine"].lease_commitment(pool["state"])
        return total

    def accepts(self, mid, r) -> bool:
        if not super().accepts(mid, r):
            return False
        pool = self._pools[mid]
        if pool.get("paged"):
            # per-block admission: can this request's cap-aware pages be
            # reserved, on top of boundary admissions already pending
            # AND the top-up entitlement resident rows still hold?  (The
            # multi_feasible oracle stays authoritative for the paper's
            # constraints — this gates physical KV.)
            need = self._pages_needed(mid, r)
            budget = self.arena.free_pages - self._pending_pages \
                - self._outstanding_pages()
            if budget < need:
                return False
        if pool["state"] is None:
            return True     # fresh cohort: full n_max headroom of its own
        return self.node_headroom(mid) >= min(r.n, pool["engine"].n_max)

    def arena_blocked(self, mid, r) -> bool:
        """``accepts`` refused ``r`` on the shared PAGE budget while the
        pool itself had room (free slot + headroom): the signal that
        cross-pool preemption can help — evicting any cohort's resident
        returns its pages to the node arena (DESIGN.md §2.3/§2.4)."""
        pool = self._pools[mid]
        if not pool.get("paged") or self.free_slots(mid) <= 0:
            return False
        if pool["state"] is not None and \
                self.node_headroom(mid) < min(r.n, pool["engine"].n_max):
            return False    # headroom-bound, not memory-bound
        need = self._pages_needed(mid, r)
        budget = self.arena.free_pages - self._pending_pages \
            - self._outstanding_pages()
        return budget < need

    def place(self, mid, r, resume=None, quant=None):
        # reserve the candidate's cap-aware pages against this boundary
        # so a burst of same-boundary admissions can't jointly overdraw
        # the arena (the reservation becomes the row's initial lease +
        # top-up entitlement once the refill lands)
        self._pending_pages += self._pages_needed(mid, r)
        super().place(mid, r, resume, quant)

    def step(self, env, k):
        finished, occupied, capacity = [], 0, 0
        # Refill clamps are computed BEFORE any pool mutates — the same
        # headroom view admission was gated on at this boundary (each
        # pool's OWN cohort headroom; the historical cross-pool MIN
        # clamp is gone — see ``node_headroom``).
        clamps = {mid: self.node_headroom(mid)
                  for mid, pool in self._pools.items()
                  if pool["pending"] and pool["state"] is not None}
        for mid, pool in self._pools.items():
            eng = pool["engine"]
            if pool["pending"]:
                # Split serving (DESIGN.md §1.1): a pending tagged with
                # a decided method only joins a cohort serving at that
                # method's canonical precision; untagged pendings are
                # method-agnostic.  Non-matching pendings stay HELD —
                # slots reserved — and form the next sub-batch, started
                # at their own method once this cohort drains.
                if pool["state"] is not None:
                    target = eng._canon_bits(pool["state"].bits)
                else:
                    q0 = pool["pending"][0][3]
                    if q0 is None:
                        q0 = pool["quant"]
                    elif pool["quant"] is None \
                            or q0.name != pool["quant"].name:
                        pool["quant"] = q0   # cohort accounting follows
                    cb = self._cohort_bits(pool)
                    target = eng.default_bits if cb is None \
                        else eng._canon_bits(cb)
                take, held = [], []
                for item in pool["pending"]:
                    q = item[3]
                    if q is None \
                            or eng._canon_bits(q.serve_bits) == target:
                        take.append(item)
                    else:
                        held.append(item)
                pool["pending"] = held
            else:
                take = []
            if take:
                slots = [s for s, _, _, _ in take]
                reqs = [r for _, r, _, _ in take]
                prompts, caps, prefixes = [], [], []
                for slot, r, resume, _ in take:
                    if resume is None:
                        # same rng draw order as the historical batched
                        # synth call — fresh admissions are bit-stable
                        p, c = eng.synth_prompts([r], self.rng)
                        prompts.append(p[0])
                        caps.append(c[0])
                        prefixes.append(None)
                    else:
                        # resume: re-prefill the ORIGINAL prompt and
                        # replay the delivered prefix bit-exactly via
                        # the engine's forced-prefix mechanism
                        prompts.append(resume["prompt"])
                        caps.append(min(r.n, eng.n_max))
                        prefixes.append(resume["prefix"])
                    pool["prompts"][slot] = prompts[-1]
                ff = max((len(p) for p in prefixes if p), default=0)
                if all(p is None for p in prefixes):
                    prefixes = None
                if pool["state"] is None:
                    pool["state"] = eng.start_chunked(
                        prompts, caps, quant_bits=self._cohort_bits(pool),
                        arena=self.arena if pool["paged"] else None,
                        prefixes=prefixes)
                    pool["t"] = 0
                else:
                    pool["state"] = eng.refill_chunked(
                        pool["state"], slots, prompts, caps,
                        t_now=pool["t"], cap_max=clamps[mid],
                        prefixes=prefixes)
                pool["resident"].update(zip(slots, reqs))
                if ff:
                    # Eager resume replay: the forced-prefix steps
                    # re-derive tokens the user ALREADY HAS, so they are
                    # burned here at the admitting boundary instead of
                    # consuming the segment grid's k-token budget — the
                    # deadline gate judges a resume on its REMAINING
                    # tokens (runtime._hopeless) and this is what makes
                    # that promise true on the engine path.  Token
                    # streams are unchanged (chunk-size invariance).
                    pool["state"] = eng.generate_chunked(pool["state"],
                                                         ff)
                    pool["t"] = min(pool["t"] + ff, eng.n_max)
        # landed reservations became real leases; re-reserve for pendings
        # still HELD for a later sub-batch (conservatively at the pool's
        # current cohort step)
        self._pending_pages = sum(
            self._pages_needed(mid, r)
            for mid, pool in self._pools.items()
            for _, r, _, _ in pool["pending"])
        for mid, pool in self._pools.items():
            eng = pool["engine"]
            occupied += len(pool["resident"])
            capacity += pool["capacity"]
            if pool["state"] is None:
                continue
            pool["state"] = eng.generate_chunked(pool["state"], k)
            # light poll: the hot path only needs the occupancy view,
            # not the (B, n_max) token buffer
            out, lengths, done, t = eng.poll_chunked(
                pool["state"], with_tokens=self.collect_tokens)
            pool["t"] = t
            caps_h = pool["state"].caps_host
            freed = []
            for slot, r in list(pool["resident"].items()):
                if done[slot] or lengths[slot] >= caps_h[slot]:
                    finished.append((mid, r, int(lengths[slot])))
                    if self.collect_tokens:
                        self.outputs[r.rid] = \
                            np.array(out[slot][:lengths[slot]])
                    del pool["resident"][slot]
                    pool["prompts"].pop(slot, None)
                    freed.append(slot)
            if pool["paged"] and freed:
                # release-on-completion: the freed pages are allocatable
                # by ANY cohort at the next admission boundary
                pool["state"] = eng.release_slots(pool["state"], freed)
            if not pool["resident"]:
                if pool["paged"]:
                    eng.release_all(pool["state"])
                pool["state"], pool["t"] = None, 0   # cohort drained
        return finished, occupied / capacity if capacity else 0.0

    def preempt(self, mid, rid):
        """Evict a resident row: spill its delivered tokens (one full
        poll), kill the row via ``evict_slots`` (paged leases return to
        the arena immediately), and hand back the original prompt plus
        the delivered prefix — everything resume needs to re-prefill and
        replay the request bit-exactly (DESIGN.md §2.4)."""
        pool = self._pools[mid]
        eng = pool["engine"]
        slot = next(s for s, r in pool["resident"].items() if r.rid == rid)
        out, lengths, done, t = eng.poll_chunked(pool["state"])
        prefix = [int(x) for x in out[slot][:lengths[slot]]]
        # tokens this row still owes AFTER the replayed prefix — the
        # deadline gate judges the resume on these, not the full n
        # (the replay itself is burned off-grid at the resuming
        # boundary; see the fast-forward in ``step``)
        remaining = max(0, int(pool["state"].caps_host[slot])
                        - len(prefix))
        pool["state"] = eng.evict_slots(pool["state"], [slot])
        del pool["resident"][slot]
        prompt = pool["prompts"].pop(slot)
        if not pool["resident"] and not pool["pending"]:
            if pool["paged"]:
                eng.release_all(pool["state"])
            pool["state"], pool["t"] = None, 0
        return {"prompt": prompt, "prefix": prefix,
                "remaining": remaining}

    def evacuate(self, mid):
        pool = self._pools[mid]
        eng = pool["engine"]
        removed = list(pool["resident"].values()) \
            + [r for _, r, _, _ in pool["pending"]]
        if pool["state"] is not None:
            eng.evict_slots(pool["state"], list(pool["resident"]))
            if pool["paged"]:
                eng.release_all(pool["state"])
        pool["resident"].clear()
        pool["pending"].clear()
        pool["prompts"].clear()
        pool["state"], pool["t"] = None, 0
        # NOTE: page reservations made for the cleared pendings stay in
        # ``_pending_pages`` until the next successful step resets it —
        # conservatively strict admission, never an arena overdraw.
        return removed

    def requant(self, mid, method):
        """Mid-flight cohort requant (DESIGN.md §2.4): on top of the
        base re-tagging, the LIVE decode state's ``bits`` are
        re-canonicalized so the very next segment's ``params_for``
        serves the re-scaled tree from the engine's multi-precision
        weight cache — a dict lookup, not a requantization pass.
        Historically degradation only re-selected methods for cohorts
        STARTING while degraded; resident cohorts kept serving at the
        pre-pressure method for their whole residency."""
        super().requant(mid, method)
        pool = self._pools[mid]
        if pool["state"] is not None:
            bits = method.serve_bits if method is not None \
                else self.quant_bits
            pool["state"] = dataclasses.replace(
                pool["state"],
                bits=pool["engine"]._canon_bits(bits))

    def topup_pages(self) -> int:
        return sum(getattr(e, "lease_topups", 0)
                   for e in self.engines.values())

    def block_usage(self):
        if self.arena is None:
            return super().block_usage()
        bt = self.arena.block_tokens
        live_tokens = 0
        for pool in self._pools.values():
            if pool.get("paged") and pool["state"] is not None:
                eng = pool["engine"]
                live_tokens += len(pool["resident"]) \
                    * (eng.s_max + pool["t"])
        alloc_tokens = self.arena.pages_in_use * bt
        return (self.arena.pages_in_use, self.arena.total_pages,
                live_tokens, alloc_tokens)


class ContinuousRuntime(EpochRuntime):
    """Continuous-batching sibling of the epoch loop (DESIGN.md §2.1).

    Same arrival / aging / viability-drop bookkeeping on the same epoch
    grid, but each epoch is split into ``segments_per_epoch`` chunked
    decode segments and ADMISSION happens at every segment boundary:
    first-fit over the queue in arrival order (``admission="fifo"``,
    the throughput default) or EDF-within-priority order
    (``admission="edf"``, the SLO stack — pair it with
    ``deadline_gated=True`` so overload does not burn slots on doomed
    tight-deadline work), each candidate
    gated by ``policy.validate()`` on (resident ∪ candidate) — the
    paper's P1 feasibility oracle reused as the admission-control
    contract, so no slot refill can violate the constraint set the
    scheduler enforces at epoch boundaries.  On a ``MultiLLMEnv`` the gate is NODE-WIDE: the
    joint resident batch across every hosted cohort is additionally
    re-checked against ``multi_feasible`` (raising
    ``InfeasibleDecisionError`` on a policy whose oracle is only
    per-model feasible), and each freshly started cohort's quantization
    method comes from ``policy.select_quant`` (the PR-2 descent for
    ``quant=auto``), recorded in ``EpochTrace.quants``.  Resident
    requests keep their admission-time waits; ``schedule()`` is never
    called — continuous batching replaces the batch-selection problem
    with per-request admission control.

    Requests are counted served when their generation FINISHES (the
    epoch runtime counts at selection; with its execute-within-the-epoch
    contract the two agree on epoch attribution).  After the last epoch
    the resident cohorts DRAIN to completion (bounded by one cohort
    span), attributed to the final epoch — so for ``warmup_epochs=0``
    conservation holds exactly, in its overload-hardened form
    (DESIGN.md §2.4)::

        arrived == served + dropped + shed
                   + len(final_queue_rids) + len(in_flight_rids)

    where ``shed`` is degradation/quarantine load shedding (distinct
    from viability drops) and ``in_flight_rids`` is empty except on the
    partial metrics a :class:`DrainStallError` carries.  Preemption
    (``preemption=True``) moves resident rows back to the queue with
    their progress spilled — the engine path resumes them by
    re-prefilling the ORIGINAL prompt and replaying the delivered
    prefix bit-exactly (forced-prefix decode; see
    ``ServingEngine._decode_chunk_fn``) — so preempted work is never
    double-counted in any bucket.  Transient data-plane faults
    (serving/faults.py) are retried up to ``retry_limit`` times per
    boundary; ``quarantine_after`` consecutive failures of one pool
    evacuate and quarantine it (shed, with accounting); ``watchdog_s``
    arms a wall-clock alarm around every step; and a
    :class:`DegradationController` lets the runtime trade precision for
    pressure relief with hysteresis.
    """

    def __init__(self, env: Env, policy: Union[str, SchedulerPolicy],
                 executor: ContinuousExecutor, k: int = 4,
                 segments_per_epoch: Optional[int] = None,
                 admission: str = "fifo",
                 deadline_gated: bool = False,
                 preemption: bool = False,
                 max_preemptions: int = 2,
                 backoff_boundaries: int = 2,
                 retry_limit: int = 3,
                 quarantine_after: int = 5,
                 watchdog_s: Optional[float] = None,
                 degradation: Optional[DegradationController] = None,
                 drain_limit: int = 100_000):
        super().__init__(env, policy)
        self.executor = self.cexec = executor
        self.k = int(k)
        self.segments_per_epoch = segments_per_epoch or max(
            1, math.ceil(executor.tokens_per_epoch() / self.k))
        # -- SLO / robustness knobs (DESIGN.md §2.4) -------------------------
        assert admission in ("edf", "fifo"), admission
        self.admission = admission          # queue order at admission:
                                            # EDF-within-priority or FIFO
        self.deadline_gated = deadline_gated  # skip candidates that
                                            # cannot finish by deadline
        self.preemption = preemption        # evict looser residents for
                                            # tighter candidates
        self.max_preemptions = max_preemptions    # eviction cap per request
        self.backoff_boundaries = backoff_boundaries  # resume backoff,
                                            # linear in attempts
        self.retry_limit = retry_limit      # step retries per boundary on
                                            # transient faults
        self.quarantine_after = quarantine_after  # consecutive pool
                                            # failures before quarantine
        self.watchdog_s = watchdog_s        # wall-clock deadline per step
                                            # (None = unarmed)
        self.degradation = degradation      # graceful-degradation
                                            # hysteresis (None = off)
        self.drain_limit = drain_limit      # post-run drain segments
                                            # before DrainStallError

    # -- admission: validate()-gated first-fit -------------------------------

    @property
    def _split_mode(self) -> bool:
        return bool(getattr(self.policy, "split", False))

    def _split_decision(self, batches: Dict[Optional[str], List[Request]],
                        quants: Dict[Optional[str], QuantMethod],
                        extra: Optional[Dict[int, QuantMethod]] = None
                        ) -> Decision:
        """Trial Decision for ``validate()``: under a split policy the
        per-model sub-batch structure is rebuilt from each resident
        row's DECIDED method (its placement tag, via
        ``cexec.decided_quant``; ``extra`` maps candidate rids not yet
        placed), so the oracle prices a mixed pool with the swap-aware
        split check instead of flattening it onto one method — the
        historical one-precision-per-cohort assumption this PR removes.
        Non-split policies get the plain flat Decision unchanged."""
        dec = Decision(batches=batches, quants=quants)
        if not self._split_mode:
            return dec
        extra = extra or {}
        for mid, batch in batches.items():
            if len(batch) < 2:
                continue
            default = quants.get(mid)
            groups: Dict[Optional[str], tuple] = {}
            for r in batch:
                q = extra[r.rid] if r.rid in extra \
                    else self.cexec.decided_quant(r.rid, default)
                key = q.name if q is not None else None
                groups.setdefault(key, ([], q))[0].append(r)
            if len(groups) > 1:
                dec.splits[mid] = [(b, q) for b, q in groups.values()]
        return dec

    def _assert_jointly_feasible(self, batches: Dict[Optional[str],
                                                     List[Request]],
                                 quants: Dict[Optional[str], QuantMethod]
                                 ) -> None:
        """Authoritative node-wide re-check on multi-LLM nodes: an
        admission boundary must leave the JOINT resident batch feasible
        under ``multi_feasible`` (shared spectrum, shared memory pool,
        sequential compute slot).  Per-model feasibility does not compose
        across cohorts on shared budgets — a policy whose oracle only
        checks its own model's view cheats the node and is caught here,
        at admission, before anything serves.  Run ONCE per boundary
        (not per candidate): every joint constraint is monotone in batch
        growth, so an infeasible intermediate state cannot become
        feasible again by the end of the loop — same detection at 1/N
        the oracle cost."""
        if not isinstance(self.env, MultiLLMEnv):
            return
        order = getattr(self.policy, "order", "weight")
        dec = self._split_decision(batches, quants)
        if not multi_feasible(self.env, batches, order=order,
                              quants=quants, splits=dec.splits or None,
                              swap_record=getattr(self.policy,
                                                  "_swap_record", None)):
            raise InfeasibleDecisionError(
                f"{self.policy.spec}: admission accepted a candidate "
                f"whose joint resident batch fails multi_feasible — "
                f"per-model feasibility does not compose on shared node "
                f"budgets")

    def _admission_order(self, queue: List[Request]) -> List[Request]:
        """The order admission considers the queue in: plain arrival
        order (``admission="fifo"``, the throughput default) or EDF
        within priority classes (``admission="edf"``, the SLO stack)."""
        return edf_order(queue) if self.admission == "edf" \
            else list(queue)

    def _hopeless(self, r: Request,
                  rec: Optional[SpillRecord]) -> bool:
        """Deadline-aware admission filter (``deadline_gated=True``):
        a candidate that cannot finish by its deadline even if served
        IMMEDIATELY — earliest finish = current boundary + one segment
        per k tokens — is never worth a slot.  Unlike the optimistic
        lone-compute bound ``still_viable`` drops on, this uses the
        runtime's own segment grid, so under overload EDF stops burning
        capacity on doomed tight-deadline work (the classic EDF overload
        collapse).  A spilled request — analytic OR engine — is judged
        on its REMAINING tokens: both preempt payloads carry
        ``"remaining"``, and the engine path burns the forced-prefix
        replay off-grid at the resuming boundary (the fast-forward in
        ``EngineContinuousExecutor.step``), so the remaining-token
        judgment is honest, not optimistic."""
        n = r.n
        if rec is not None and "remaining" in rec.payload:
            n = rec.payload["remaining"]
        dt = self.T_E / self.segments_per_epoch
        t_fin = self._tnow + math.ceil(max(1, int(n)) / self.k) * dt
        return t_fin > r.deadline + 1e-9

    def _degraded_quant(self, mid: Optional[str],
                        reqs: List[Request]) -> Optional[QuantMethod]:
        """Degraded-mode cohort method: the FASTEST admissible method
        for the prospective pool — accuracy floors stay binding
        (``candidate_methods`` prefilters on the batch's a_i), but the
        throughput-vs-accuracy descent is skipped in favor of minimum
        compute time (min beta) while the node is under pressure."""
        env_r = self.env.envs[mid] if isinstance(self.env, MultiLLMEnv) \
            else self.env
        cands = candidate_methods(
            env_r.model.arch_id,
            accuracies=[r.a for r in reqs] if reqs else None)
        return cands[0] if cands else None

    def _requant_live(self, m: EpochMetrics, trace: EpochTrace,
                      counting: bool,
                      queue: Sequence[Request] = ()) -> None:
        """Degradation RISING EDGE: re-select the serving method for
        LIVE cohorts too, not just cohorts that start while degraded —
        the historical gap left a mid-flight cohort serving at the
        pre-pressure method for its whole residency, so a long cohort
        admitted just before overload never degraded at all.  Each
        non-quarantined pool with residents gets the fastest method
        admissible for its resident batch AND the (post-shed) queued
        work headed its way (``_degraded_quant``) — flipping below the
        queue's accuracy demand would just trade overload for
        accuracy-starvation, since refills whose floor exceeds the
        cohort's method fail joint validation at every boundary until
        the pool drains.  If the pick differs from the cohort's current
        method and the oracle accepts the re-pointed joint batch, the
        executor requants the cohort mid-flight (``cexec.requant`` — on
        engines a multi-precision weight-cache lookup at the next
        segment) with explicit accounting (``EpochMetrics.requanted``);
        the pre-flip method is remembered for the falling-edge
        restore.

        Skipped entirely on serving-inert planes
        (``cexec.requant_effective`` False, e.g. the analytic
        executor): there a flip changes nothing the plane delivers
        while still loosening the oracle's admission bound — pure
        pricing optimism."""
        cexec = self.cexec
        if not cexec.requant_effective:
            return
        batches = {mm: cexec.resident(mm) for mm in cexec.pool_ids()}
        quants = {mm: q for mm in cexec.pool_ids()
                  if batches[mm] and (q := cexec.quant_of(mm)) is not None}
        for mid in cexec.pool_ids():
            if mid in self._quarantined or not batches[mid]:
                continue
            inbound = [r for r in queue
                       if getattr(r, "model_id", None) == mid]
            q = self._degraded_quant(mid, batches[mid] + inbound)
            cur = cexec.quant_of(mid)
            if q is None or (cur is not None and q.name == cur.name):
                continue
            trial = dict(quants)
            trial[mid] = q
            if not self.policy.validate(
                    self.env,
                    self._split_decision(
                        batches, trial,
                        extra={r.rid: q for r in batches[mid]})):
                continue
            self._requant_prior[mid] = (cur, q.name)
            cexec.requant(mid, q)
            quants = trial
            trace.quants[mid] = q.name
            if counting:
                m.requanted += 1

    def _requant_restore(self, m: EpochMetrics, trace: EpochTrace,
                         counting: bool) -> None:
        """Degradation FALLING edge: undo the rising-edge flips.  A
        requanted cohort otherwise keeps its degraded (fast,
        low-accuracy) method until its pool fully drains — and under
        continuous refill a pool may never drain, so queued work whose
        accuracy floor exceeds the degraded method's accuracy starves
        long after the pressure cleared (it fails joint validation
        against the cohort's method at every boundary).  Each pool
        whose rising-edge flip is still in effect is re-pointed at its
        pre-flip method under the same oracle gate; a pool that turned
        over since, or whose restore fails validation, keeps its
        current method — the next cohort start re-decides anyway."""
        cexec = self.cexec
        prior_map, self._requant_prior = self._requant_prior, {}
        batches = {mm: cexec.resident(mm) for mm in cexec.pool_ids()}
        quants = {mm: q for mm in cexec.pool_ids()
                  if batches[mm] and (q := cexec.quant_of(mm)) is not None}
        for mid, (prior, flipped) in prior_map.items():
            if mid in self._quarantined or not batches.get(mid):
                continue
            cur = cexec.quant_of(mid)
            if cur is None or cur.name != flipped:
                continue                  # cohort turned over since
            trial = dict(quants)
            if prior is None:
                trial.pop(mid, None)
            else:
                trial[mid] = prior
            if not self.policy.validate(
                    self.env,
                    self._split_decision(
                        batches, trial,
                        extra={r.rid: prior for r in batches[mid]})):
                continue
            cexec.requant(mid, prior)
            quants = trial
            env_r = self.env.envs[mid] \
                if isinstance(self.env, MultiLLMEnv) else self.env
            trace.quants[mid] = prior.name if prior is not None \
                else env_r.quant.name
            if counting:
                m.requanted += 1

    def _auto_calibrate(self) -> None:
        """Run-start warmup calibration (engine data planes only): a
        policy declaring ``calib="measured"`` with nothing installed
        gets a quick ``measure_beta`` pass on the hosted engine(s) —
        measured betas + measured weight-residency alphas
        (``attach_alphas``) — and a split policy with no swap record
        gets ``measure_swap_cost``, so ``dftsp:quant=auto,split=true``
        drives the continuous engine path with MEASURED coefficients
        out of the box instead of raising at the first descent."""
        engines = getattr(self.cexec, "engines", None)
        if not engines:
            return
        eng = next(iter(engines.values()))
        policy = self.policy
        if getattr(policy, "calib", None) == "measured" \
                and getattr(policy, "_measured", None) is None:
            from repro_torch.quant.calibration import (attach_alphas,
                                                 measure_beta,
                                                 measured_methods)
            record = measure_beta(
                eng, batches=(1, min(4, eng.batch_capacity)), iters=1,
                n_tokens=4, prompt_len=4)
            attach_alphas(record, eng._raw_params)
            policy.install_measured(measured_methods(record))
        if getattr(policy, "split", False) \
                and getattr(policy, "_swap_record", None) is None:
            from repro_torch.quant.calibration import measure_swap_cost
            policy.install_swap_costs(measure_swap_cost(eng, iters=1))

    def _try_admit(self, queue: List[Request], trace: EpochTrace,
                   degraded: bool = False) -> List[Request]:
        """Admit queued requests into free slots — first-fit in
        ``_admission_order`` — each gated by the policy's own
        feasibility oracle on the joint resident-plus-candidate batch —
        evaluated under every active cohort's decided quantization
        method — then re-checked against the joint ``multi_feasible``
        oracle on multi-LLM nodes.  The resident view is built once per
        boundary and updated incrementally as candidates land.

        The first admission into an empty pool STARTS a cohort: the
        policy picks its quantization method (``select_quant``, the
        PR-2 descent for ``quant=auto`` policies; the fastest
        admissible method while ``degraded``) over the queued requests
        targeting that model, the executor pins the cohort to it, and
        the choice is recorded in ``trace.quants``.

        Quarantined pools admit nothing, and a preempted request still
        inside its backoff window (``SpillRecord.not_before``) is
        skipped this boundary; when a spilled request IS re-admitted,
        its resume payload rides along so the executor restores the
        spilled progress."""
        admitted: List[Request] = []
        cexec = self.cexec
        batches = {m: cexec.resident(m) for m in cexec.pool_ids()}
        # methods the ACTIVE cohorts are being served with (a drained
        # pool's stale method is ignored: its next cohort re-decides)
        quants = {m: q for m in cexec.pool_ids()
                  if batches[m] and (q := cexec.quant_of(m)) is not None}
        fresh_sel: Dict[Optional[str], Optional[QuantMethod]] = {}
        for r in self._admission_order(queue):
            mid = r.model_id
            if mid in self._quarantined:
                continue
            rec = self._spills.get(r.rid)
            if rec is not None and self._boundary < rec.not_before:
                continue               # resume backoff not yet elapsed
            if self.deadline_gated and self._hopeless(r, rec):
                continue               # can't finish by deadline anyway
            if mid not in batches or not cexec.accepts(mid, r):
                continue
            starting = not batches[mid]
            if starting:
                if mid not in fresh_sel:
                    pool_reqs = [x for x in queue if x.model_id == mid]
                    fresh_sel[mid] = self._degraded_quant(mid, pool_reqs) \
                        if degraded else self.policy.select_quant(
                            self.env, mid, pool_reqs)
                q = fresh_sel[mid]
            else:
                q = quants.get(mid)
            batches[mid].append(r)
            trial = dict(quants)
            if q is not None:
                trial[mid] = q
            ok = self.policy.validate(
                self.env, self._split_decision(batches, trial,
                                               extra={r.rid: q}))
            if not ok and self._split_mode and not degraded:
                # SPLIT fallback (DESIGN.md §1.1): the candidate is
                # infeasible at the cohort's method — re-decide a method
                # for it ALONE and try it as its own sub-batch (the
                # executor holds it until the live sub-batch drains, so
                # differently-quantized rows serve back to back with
                # the swap cost priced by the split oracle)
                q2 = self.policy.select_quant(self.env, mid, [r])
                if q2 is not None and (q is None or q2.name != q.name):
                    trial2 = dict(quants)
                    if starting:
                        trial2[mid] = q2   # fresh cohort: start AT q2
                    elif q is not None:
                        trial2[mid] = q    # primary stays the cohort's
                    if self.policy.validate(
                            self.env,
                            self._split_decision(batches, trial2,
                                                 extra={r.rid: q2})):
                        ok, q, trial = True, q2, trial2
            if ok:
                if starting:
                    cexec.set_quant(mid, q)
                    if q is not None:
                        trace.quants[mid] = q.name
                quants = trial
                cexec.place(mid, r,
                            resume=rec.payload if rec is not None else None,
                            quant=q if self._split_mode else None)
                admitted.append(r)
            else:
                batches[mid].pop()
        if admitted:
            self._assert_jointly_feasible(batches, quants)
        return admitted

    def _try_preempt(self, queue: List[Request], trace: EpochTrace,
                     m: EpochMetrics, counting: bool
                     ) -> Tuple[List[Request], List[Request]]:
        """Priority preemption at a segment boundary (DESIGN.md §2.4).

        For each still-queued candidate (in admission order) whose
        admission is BOUND — its pool out of slots, or the shared KV
        arena refusing its pages (``arena_blocked``) — find a resident
        victim the candidate strictly beats (``pick_victim``: higher
        priority class, or same class with an earlier deadline), check
        the policy oracle still holds on the swapped batch, then evict
        the victim — spilling its progress into a :class:`SpillRecord`
        — and admit the candidate into the freed capacity.  When the
        pool is slot-bound, victims come from the candidate's own pool
        (a freed slot elsewhere is useless); when the ARENA binds,
        victims come from EVERY healthy pool — any cohort's released
        pages free the shared node budget, the cross-model eviction the
        historical intra-pool-only rule could not express (a
        high-priority admission was shed despite evictable low-priority
        pages in another cohort).  Eviction repeats until the candidate
        fits or no admissible victim remains (bounded: residents
        strictly shrink).  Victims re-enter the queue and resume later
        via their spill payload; a victim already evicted
        ``max_preemptions`` times is pinned (never evicted again), and
        each eviction pushes the victim's earliest re-admission out by
        ``backoff_boundaries × attempts`` segment boundaries.

        Returns ``(admitted_candidates, requeued_victims)``."""
        cexec = self.cexec
        admitted: List[Request] = []
        requeued: List[Request] = []
        if not queue:
            return admitted, requeued
        batches = {mm: cexec.resident(mm) for mm in cexec.pool_ids()}
        quants = {mm: q for mm in cexec.pool_ids()
                  if batches[mm] and (q := cexec.quant_of(mm)) is not None}
        changed = False
        for r in self._admission_order(queue):
            mid = r.model_id
            if mid in self._quarantined or mid not in batches:
                continue
            rec = self._spills.get(r.rid)
            if rec is not None and self._boundary < rec.not_before:
                continue           # candidate itself is backing off
            if self.deadline_gated and self._hopeless(r, rec):
                continue           # not worth evicting anyone for
            slot_bound = cexec.free_slots(mid) <= 0
            if not slot_bound and not cexec.arena_blocked(mid, r):
                continue           # not bound; admission had its shot
            vpools = [mid] if slot_bound else \
                [p for p in cexec.pool_ids() if p not in self._quarantined]
            while True:
                eligible = [v for p in vpools for v in cexec.evictable(p)
                            if (self._spills[v.rid].attempts
                                if v.rid in self._spills else 0)
                            < self.max_preemptions]
                victim = pick_victim(eligible, r)
                if victim is None:
                    break
                vmid = victim.model_id
                trial_batches = dict(batches)
                trial_batches[vmid] = [x for x in batches[vmid]
                                       if x.rid != victim.rid]
                trial_batches[mid] = trial_batches[mid] + [r]
                if not self.policy.validate(
                        self.env,
                        self._split_decision(trial_batches, quants)):
                    break
                payload = cexec.preempt(vmid, victim.rid)
                prev = self._spills.get(victim.rid)
                attempts = prev.attempts + 1 if prev is not None else 1
                self._spills[victim.rid] = SpillRecord(
                    request=victim, payload=payload, attempts=attempts,
                    not_before=self._boundary
                    + self.backoff_boundaries * attempts)
                requeued.append(victim)
                trace.preempted_rids.append(victim.rid)
                if counting:
                    m.preempted += 1
                changed = True
                batches[vmid] = [x for x in batches[vmid]
                                 if x.rid != victim.rid]
                if cexec.accepts(mid, r):
                    cexec.place(mid, r,
                                resume=rec.payload if rec is not None
                                else None)
                    admitted.append(r)
                    batches[mid] = batches[mid] + [r]
                    break
        if changed:
            self._assert_jointly_feasible(batches, quants)
        return admitted, requeued

    def _shed_queue(self, queue: List[Request], m: EpochMetrics,
                    trace: EpochTrace, counting: bool) -> List[Request]:
        """Degraded-mode load shedding: drop the controller's chosen
        lowest-priority queued work with explicit accounting (``shed``
        is a separate conservation bucket from viability drops)."""
        to_shed = self.degradation.shed_candidates(queue)
        if not to_shed:
            return queue
        gone = set()
        for r in to_shed:
            gone.add(r.rid)
            trace.shed_rids.append(r.rid)
            if counting:
                m.shed += 1
        return [r for r in queue if r.rid not in gone]

    def _quarantine(self, mid: Optional[str], m: EpochMetrics,
                    trace: EpochTrace, counting: bool) -> None:
        """Quarantine pool ``mid`` after ``quarantine_after`` consecutive
        step failures: evacuate everything it holds (shed, with
        accounting — cross-model redistribution is impossible since a
        request targets one hosted model), and stop admitting into it
        for the rest of the run."""
        removed = self.cexec.evacuate(mid)
        self._quarantined.add(mid)
        m.quarantined.append(str(mid))
        for r in removed:
            trace.shed_rids.append(r.rid)
            if counting:
                m.shed += 1
            self._first_token.pop(r.rid, None)
            self._spills.pop(r.rid, None)

    def _step_guarded(self, m: EpochMetrics, trace: EpochTrace,
                      counting: bool) -> Tuple[List, float, float]:
        """One data-plane step under the fault-handling contract:
        retry transient failures (raised BEFORE any state mutated, so a
        replay is safe) up to ``retry_limit`` times, trip the watchdog
        on steps exceeding ``watchdog_s`` wall seconds, and quarantine a
        pool after ``quarantine_after`` CONSECUTIVE failures.  A
        boundary whose retry budget is exhausted is skipped — no
        progress, but the loop survives and the next boundary retries.
        Returns ``(finished, occupancy, wall_s)``."""
        wall_total = 0.0
        for attempt in range(self.retry_limit + 1):
            t0 = time.perf_counter()
            try:
                finished, occ = self.cexec.step(self.env, self.k)
            except TransientStepError as e:
                wall_total += time.perf_counter() - t0
                trace.faults += 1
                if counting:
                    m.faults_injected += 1
                key = e.mid
                self._streaks[key] = self._streaks.get(key, 0) + 1
                if key in self.cexec.pool_ids() \
                        and key not in self._quarantined \
                        and self._streaks[key] >= self.quarantine_after:
                    self._quarantine(key, m, trace, counting)
                    self._streaks[key] = 0
                if attempt < self.retry_limit:
                    if counting:
                        m.retried += 1
                    continue
                return [], 0.0, wall_total
            wall = time.perf_counter() - t0
            wall_total += wall
            if self.watchdog_s is not None and wall > self.watchdog_s \
                    and counting:
                m.watchdog_trips += 1
            self._streaks.clear()   # a successful step ran every pool
            return finished, occ, wall_total
        return [], 0.0, wall_total  # unreachable; loop always returns

    def _record_blocks(self, counting: bool, m: EpochMetrics,
                       trace: EpochTrace) -> None:
        """Per-segment KV-block accounting (DESIGN.md §2.3): the
        executor's ``block_usage`` snapshot feeds the trace's in-use
        series and the run-level occupancy/fragmentation aggregates."""
        in_use, total, live_tok, alloc_tok = self.cexec.block_usage()
        trace.kv_blocks_in_use.append(in_use)
        trace.kv_blocks_total = total
        if counting:
            m.kv_alloc_tokens += alloc_tok
            m.kv_dead_tokens += max(0, alloc_tok - live_tok)
            m.kv_topup_pages = self.cexec.topup_pages() - self._topup0

    def _record_finished(self, finished: Sequence, counting: bool,
                         m: EpochMetrics, trace: EpochTrace,
                         now: Optional[float] = None) -> None:
        for mid, r, tokens in finished:
            trace.finished_rids.append(r.rid)
            trace.generated_tokens += tokens
            if counting:
                m.served += 1
                m.generated_tokens += tokens
                m.served_by_model[mid] = \
                    m.served_by_model.get(mid, 0) + 1
                name = self.cexec.method_name(mid, self._env_for(r),
                                              rid=r.rid)
                m.served_by_method[name] = \
                    m.served_by_method.get(name, 0) + 1
            if now is None:
                continue
            # SLO accounting in simulated time (DESIGN.md §2.4): the
            # request completes at the END of the segment it finished
            # in; its first token landed at the end of the segment that
            # admitted it.
            lat = now - r.arrival
            met = lat <= r.tau + 1e-9
            if counting:
                m.latencies.append(lat)
                if met:
                    m.slo_met += 1
                ft = self._first_token.get(r.rid)
                if ft is not None:
                    m.ttfts.append(ft - r.arrival)
                    if tokens > 1 and now > ft:
                        m.tpots.append((now - ft) / (tokens - 1))
            if self.degradation is not None:
                self.degradation.record_finish(met)
            self._first_token.pop(r.rid, None)
            self._spills.pop(r.rid, None)

    def run(self, rate: Optional[float] = None, n_epochs: int = 30,
            seed: int = 0, gen: Optional[RequestGenerator] = None,
            warmup_epochs: int = 1,
            tag_arrivals: Optional[Callable[[List[Request]],
                                            List[Request]]] = None
            ) -> EpochMetrics:
        gen = self._resolve_gen(rate, seed, gen)
        T_E = self.T_E
        n_seg = self.segments_per_epoch
        dt = T_E / n_seg
        self.cexec.bind(self.env)
        self._auto_calibrate()
        self._topup0 = self.cexec.topup_pages()   # engines may be reused
        m = EpochMetrics(n_epochs=n_epochs, T_E=T_E)
        queue: List[Request] = []
        trace: Optional[EpochTrace] = None
        # per-run SLO / robustness state (DESIGN.md §2.4)
        self._spills: Dict[int, SpillRecord] = {}
        self._quarantined: set = set()
        self._streaks: Dict[Optional[str], int] = {}
        self._boundary = 0              # global segment-boundary index
        self._first_token: Dict[int, float] = {}
        self._tnow = 0.0                # current boundary's segment start
        self._was_degraded = False      # degradation edge detector
        self._requant_prior = {}        # mid -> (pre-flip method, name)
        now = 0.0

        for e in range(n_epochs + warmup_epochs):
            counting = e >= warmup_epochs
            trace = EpochTrace(epoch=e, arrived=0, dropped=0,
                               selected_rids=[], counted=counting)
            for j in range(n_seg):
                t_seg = e * T_E + j * dt
                self._tnow = t_seg
                now = t_seg + dt
                # requests that arrived during the previous SEGMENT join
                # here — the epoch loop's boundary rule, at segment grain
                arrivals = gen.within(t_seg - dt, t_seg) if (e or j) else []
                if tag_arrivals is not None:
                    arrivals = tag_arrivals(arrivals)
                trace.arrived += len(arrivals)
                if counting:
                    m.arrived += len(arrivals)
                queue.extend(arrivals)

                queue, n_dropped = self._age_and_drop(queue, t_seg)
                trace.dropped += n_dropped
                if counting:
                    m.dropped += n_dropped

                # graceful degradation: advance the hysteresis, and in
                # degraded mode shed the controller's lowest-priority
                # queued work before admission considers it
                degraded = False
                if self.degradation is not None:
                    degraded = self.degradation.observe(len(queue))
                    if degraded:
                        if counting:
                            m.degraded_segments += 1
                        queue = self._shed_queue(queue, m, trace,
                                                 counting)
                        if not self._was_degraded:
                            # rising edge: LIVE cohorts degrade too,
                            # not just the ones that start from now on
                            self._requant_live(m, trace, counting,
                                               queue)
                    elif self._was_degraded and self._requant_prior:
                        # falling edge: restore the pre-flip methods so
                        # high-accuracy queued work stops starving
                        self._requant_restore(m, trace, counting)
                    self._was_degraded = degraded

                admitted = self._try_admit(queue, trace, degraded)
                if self.preemption:
                    got = {r.rid for r in admitted}
                    rest = [r for r in queue if r.rid not in got]
                    preempt_admits, requeued = self._try_preempt(
                        rest, trace, m, counting)
                    admitted = admitted + preempt_admits
                if admitted:
                    got = {r.rid for r in admitted}
                    queue = [r for r in queue if r.rid not in got]
                    trace.selected_rids.extend(r.rid for r in admitted)
                    if j > 0:
                        trace.admitted_mid_epoch += len(admitted)
                        if counting:
                            m.admitted_mid_epoch += len(admitted)
                    for r in admitted:
                        if r.rid in self._spills and counting:
                            m.resumed += 1
                        self._first_token.setdefault(r.rid, now)
                if self.preemption and requeued:
                    queue.extend(requeued)

                finished, occ, wall = self._step_guarded(m, trace,
                                                         counting)
                self._boundary += 1
                trace.wall_s += wall
                trace.segments += 1
                trace.occupancy.append(occ)
                self._record_blocks(counting, m, trace)
                if counting:
                    m.segments += 1
                self._record_finished(finished, counting, m, trace,
                                      now=now)

            if counting:
                m.batch_sizes.append(len(trace.selected_rids))
                m.wall_s += trace.wall_s
            m.traces.append(trace)

        # drain resident cohorts (bounded: every healthy step makes
        # progress and nothing new is admitted), attributed to the final
        # epoch; simulated time keeps advancing on the segment grid so
        # drain-finishing requests get honest latencies
        counting = n_epochs > 0
        for _ in range(self.drain_limit):
            if self.cexec.idle():
                break
            finished, occ, wall = self._step_guarded(m, trace, counting)
            self._boundary += 1
            now += dt
            trace.wall_s += wall
            trace.segments += 1
            trace.occupancy.append(occ)
            self._record_blocks(counting, m, trace)
            if counting:
                m.segments += 1
                m.wall_s += wall
            self._record_finished(finished, counting, m, trace, now=now)
        else:
            # a stalled drain still hands back everything it knows: the
            # partial metrics (with the rows still resident named in
            # ``in_flight_rids``) ride on the typed error, keeping the
            # conservation equation checkable from the exception alone
            m.final_queue_rids = [r.rid for r in queue]
            m.in_flight_rids = [r.rid for mid in self.cexec.pool_ids()
                                for r in self.cexec.resident(mid)]
            raise DrainStallError(
                f"continuous drain did not converge within "
                f"{self.drain_limit} segments "
                f"({len(m.in_flight_rids)} rows in flight)",
                metrics=m, resident_rids=m.in_flight_rids)

        m.final_queue_rids = [r.rid for r in queue]
        return m

"""SchedulerPolicy: the pluggable control plane behind the epoch runtime.

A policy is a class with two methods:

    schedule(env, queue) -> Decision     pick this epoch's batch(es)
    validate(env, decision) -> bool      the policy's own feasibility oracle

carrying its own oracle is the point: the runtime re-checks every decision
without knowing which problem variant the policy solves (P1 for batch
schedulers, the per-unit NoB constraints, or the shared-budget joint
problem for multi-LLM) — this replaces the old ``is_nob`` scheduler-name
string matching in the simulation loop.

``Decision`` holds one batch per hosted model (single-model policies use
the ``None`` key), so ``multi_dftsp`` is a first-class policy instead of a
signature outlier.

Policies are registered by decorator and built from parameterized string
specs::

    get_policy("dftsp")                      # defaults
    get_policy("dftsp:d_sweep=false")        # fast heuristic variant
    get_policy("multi-dftsp:order=name")     # joint scheduler, name order

``policy.spec`` reconstructs the canonical spec (registry round-trip:
``get_policy(get_policy(s).spec).spec == s`` for canonical ``s``).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

from repro_torch.core import multi as _multi
from repro_torch.core import problem
from repro_torch.core import schedulers as _legacy
from repro_torch.core.dftsp import (SearchStats, dftsp_schedule,
                              dftsp_schedule_auto, dftsp_schedule_split)
from repro_torch.core.environment import EdgeEnv
from repro_torch.core.quantization import METHODS, QuantMethod, get_method
from repro_torch.core.request import Request

Env = Union[EdgeEnv, "_multi.MultiLLMEnv"]


class InfeasibleDecisionError(RuntimeError):
    """A scheduling decision failed its policy's own feasibility oracle.

    Raised by the runtime's authoritative re-check (and by executor
    capacity clamping) when ``policy.validate`` rejects what
    ``policy.schedule`` produced — i.e. the scheduler cheated its own
    contract.  A dedicated exception rather than a bare ``assert`` so the
    control-plane contract survives ``python -O``.
    """


class DrainStallError(RuntimeError):
    """The end-of-run drain stopped making progress (a wedged executor,
    a cohort that can never finish, or the drain bound exhausted).

    Replaces the historical bare ``RuntimeError("continuous drain did
    not converge")``: instead of losing the whole run, the error carries
    the PARTIAL :class:`~repro_torch.core.metrics.EpochMetrics` accumulated so
    far (with ``in_flight_rids`` naming the rows still resident) so
    callers can account for every request even when the node wedges —
    the conservation invariant ``arrived == served + dropped + shed +
    queued + in_flight`` stays checkable from the exception alone.
    """

    def __init__(self, message: str, metrics=None,
                 resident_rids: Sequence[int] = ()):
        super().__init__(message)
        self.metrics = metrics
        self.resident_rids = list(resident_rids)


@dataclass
class Decision:
    """One epoch's scheduling outcome: per-model batches + per-model
    quantization assignments + search stats.

    Single-model policies put their batch under the ``None`` key; the
    multi-LLM policy keys batches by hosted ``model_id``.  ``quants``
    records the method the control plane decided for each batch; a
    missing key means "the env's deployed method" (so fixed-method
    policies stay bit-identical to the pre-decision behavior).

    ``splits`` carries the split-epoch extension (DESIGN.md §1.1): when a
    model's entry is present, its epoch queue is served as that ordered
    list of ``(sub_batch, method)`` pairs — sequentially, each at its own
    precision, with the weight-swap cost between them charged in epoch
    time.  The flat ``batches[mid]`` ALWAYS equals the concatenation of
    the sub-batches (so ``selected``/``size``/executor admission are
    split-agnostic), and ``quants[mid]`` records the PRIMARY (first)
    sub-batch's method.
    """
    batches: Dict[Optional[str], List[Request]]
    stats: SearchStats = field(default_factory=SearchStats)
    quants: Dict[Optional[str], QuantMethod] = field(default_factory=dict)
    splits: Dict[Optional[str], List[Tuple[List[Request], QuantMethod]]] = \
        field(default_factory=dict)

    @classmethod
    def single(cls, selected: Sequence[Request],
               stats: Optional[SearchStats] = None,
               quant: Optional[QuantMethod] = None) -> "Decision":
        return cls(batches={None: list(selected)},
                   stats=stats or SearchStats(),
                   quants={} if quant is None else {None: quant})

    def sub_batches(self, model_id: Optional[str], env: Env
                    ) -> List[Tuple[List[Request], QuantMethod]]:
        """The (batch, method) sub-batches serving ``model_id`` — the
        recorded split when one exists, else the whole batch at the
        decided (or deployed) method."""
        subs = self.splits.get(model_id)
        if subs:
            return subs
        batch = self.batches.get(model_id, [])
        return [(batch, self.quant_for(model_id, env))] if batch else []

    def quant_for(self, model_id: Optional[str], env: Env) -> QuantMethod:
        """The method this decision serves ``model_id`` with (falls back
        to the deployment default frozen in the env)."""
        q = self.quants.get(model_id)
        if q is not None:
            return q
        if isinstance(env, _multi.MultiLLMEnv):
            return env.envs[model_id].quant
        return env.quant

    @property
    def selected(self) -> List[Request]:
        """All scheduled requests, flattened in model order."""
        return [r for batch in self.batches.values() for r in batch]

    @property
    def size(self) -> int:
        return sum(len(b) for b in self.batches.values())


class SchedulerPolicy:
    """Base class: one scheduling algorithm + its feasibility oracle."""

    name: str = "?"

    def schedule(self, env: Env, queue: Sequence[Request]) -> Decision:
        raise NotImplementedError

    def validate(self, env: Env, decision: Decision) -> bool:
        """Default oracle: the full P1 constraint set on the flat batch,
        evaluated under the decision's quant assignment (if any)."""
        return problem.feasible(env, decision.selected,
                                quant=decision.quants.get(None))

    def select_quant(self, env: Env, model_id: Optional[str],
                     batch: Sequence[Request]) -> Optional[QuantMethod]:
        """The method a freshly starting continuous-batching COHORT of
        ``model_id`` should be served with, given the queued requests
        ``batch`` it would be built from (``None`` = the env's deployed
        method).

        The continuous runtime never calls ``schedule()`` — admission
        replaces batch selection — so this is where the quantization
        decision surfaces on that path: policies with a pinned method
        return it, and ``quant="auto"`` policies run the PR-2 descent
        (accuracy prefilter + Pareto pruning + (z, method) descent) over
        the prospective cohort pool.  The default keeps the deployed
        method, which is bit-identical to the pre-decision behavior.
        """
        return None

    @property
    def spec(self) -> str:
        """Canonical registry spec (non-default constructor params only)."""
        parts = []
        sig = inspect.signature(type(self).__init__)
        for k, p in sig.parameters.items():
            if k == "self" or p.default is inspect.Parameter.empty:
                continue
            v = getattr(self, k, p.default)
            if v != p.default:
                parts.append(f"{k}={_format_value(v)}")
        return self.name + (":" + ",".join(sorted(parts)) if parts else "")

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.spec!r}>"


# ---------------------------------------------------------------------------
# Registry: decorator + parameterized string specs
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[SchedulerPolicy]] = {}


def register(name: str) -> Callable[[Type[SchedulerPolicy]],
                                    Type[SchedulerPolicy]]:
    """Class decorator: make a policy buildable via ``get_policy(name)``."""
    def deco(cls: Type[SchedulerPolicy]) -> Type[SchedulerPolicy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def _coerce_value(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _format_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def parse_spec(spec: str) -> Tuple[str, Dict[str, object]]:
    """``"name:key=val,key2=val2"`` -> (name, params).  Values are coerced
    to bool/int/float when they parse as one."""
    name, _, tail = spec.partition(":")
    params: Dict[str, object] = {}
    if tail:
        for item in tail.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"malformed policy spec {spec!r}: "
                                 f"expected key=value, got {item!r}")
            params[k.strip()] = _coerce_value(v.strip())
    return name.strip(), params


def get_policy(spec: Union[str, SchedulerPolicy]) -> SchedulerPolicy:
    """Build a policy from a registry spec (idempotent on policy objects)."""
    if isinstance(spec, SchedulerPolicy):
        return spec
    name, params = parse_spec(spec)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    try:
        return cls(**params)
    except TypeError as e:
        raise TypeError(f"bad params for policy {name!r}: {e}") from e


def available() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Single-model policies (wrapping the pure scheduling functions)
# ---------------------------------------------------------------------------


def _resolve_quant_param(quant: str) -> Optional[QuantMethod]:
    """``"env"`` -> None (deployed method), ``"auto"`` handled by callers,
    else a METHODS name (e.g. ``"W4A16-GPTQ"``)."""
    if quant == "env":
        return None
    if quant not in METHODS:
        raise ValueError(f"unknown quant selector {quant!r} "
                         f"(expected env|auto|{'|'.join(sorted(METHODS))})")
    return get_method(quant)


@register("dftsp")
class DftspPolicy(SchedulerPolicy):
    """Paper Algorithm 1 (optimal DFS tree search with online pruning).

    ``quant`` turns the Fig. 6 trade-off into a scheduling decision:
    ``"env"`` (default) keeps the env's deployed method, a METHODS name
    pins an explicit method, and ``"auto"`` selects the
    throughput-optimal admissible method per epoch
    (``dftsp_schedule_auto``).

    ``calib`` picks the coefficient source the ``auto`` descent runs on:
    ``"table2"`` (default) uses the paper's Table-II METHODS, and
    ``"measured"`` uses engine-measured records installed via
    :meth:`install_measured` (quant/calibration.measured_methods) — the
    scheduler then optimizes for the engine it actually drives.
    """

    def __init__(self, prune: bool = True, order_desc: bool = True,
                 d_sweep: bool = True, fast_z_bound: bool = True,
                 quant: str = "env", calib: str = "table2",
                 split: bool = False):
        if calib not in ("table2", "measured"):
            raise ValueError(f"unknown calib source {calib!r} "
                             "(expected table2|measured)")
        if split and quant != "auto":
            raise ValueError("split=true needs quant=auto — a split epoch "
                             "is a choice BETWEEN methods per sub-batch")
        self.prune = prune
        self.order_desc = order_desc
        self.d_sweep = d_sweep
        self.fast_z_bound = fast_z_bound
        self.quant = quant
        self.calib = calib
        self.split = split
        self._measured: Optional[Dict[str, QuantMethod]] = None
        self._swap_record: Optional[Dict] = None
        if quant != "auto":
            _resolve_quant_param(quant)     # fail fast on bad names

    def install_measured(self, methods: Dict[str, QuantMethod]) -> None:
        """Install engine-measured QuantMethod records (used by the auto
        descent when ``calib="measured"``)."""
        self._measured = dict(methods)

    def install_swap_costs(self, record: Optional[Dict]) -> None:
        """Install a ``quant/calibration.measure_swap_cost`` record: the
        split descent and the split oracle then charge the MEASURED
        weight-swap latency between sub-batch methods (no record = the
        Table-II reproduction's free-swap pricing)."""
        self._swap_record = dict(record) if record else None

    def _method_pool(self):
        """The candidate METHODS the auto descent draws from, or None for
        the Table-II default."""
        if self.calib != "measured":
            return None
        if self._measured is None:
            raise RuntimeError(
                "calib='measured' needs install_measured() — run "
                "quant/calibration.measure_beta on the serving engine "
                "and install measured_methods() first")
        return list(self._measured.values())

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        kw = dict(prune=self.prune, order_desc=self.order_desc,
                  d_sweep=self.d_sweep, fast_z_bound=self.fast_z_bound)
        if self.split:
            subs, stats = dftsp_schedule_split(
                env, queue, methods=self._method_pool(),
                swap_record=self._swap_record, **kw)
            flat = [r for b, _ in subs for r in b]
            return Decision(
                batches={None: flat}, stats=stats,
                quants={None: subs[0][1]} if subs else {},
                splits={None: subs} if len(subs) > 1 else {})
        if self.quant == "auto":
            sel, method, stats = dftsp_schedule_auto(
                env, queue, methods=self._method_pool(), **kw)
            return Decision.single(sel, stats, quant=method)
        q = _resolve_quant_param(self.quant)
        sel, stats = dftsp_schedule(env, queue, quant=q, **kw)
        return Decision.single(sel, stats, quant=q)

    def validate(self, env: EdgeEnv, decision: Decision) -> bool:
        """Split-aware oracle: a split decision is checked per sub-batch
        at its OWN method with the swap cost charged serially
        (``problem.split_feasible``); single-method decisions keep the
        historical flat P1 check."""
        subs = decision.splits.get(None)
        if subs:
            return problem.split_feasible(env, subs,
                                          swap_record=self._swap_record)
        return super().validate(env, decision)

    def select_quant(self, env: EdgeEnv, model_id: Optional[str],
                     batch: Sequence[Request]) -> Optional[QuantMethod]:
        if self.quant == "env" or not batch:
            return None
        if self.quant != "auto":
            return _resolve_quant_param(self.quant)
        _, method, _ = dftsp_schedule_auto(env, list(batch),
                                           methods=self._method_pool())
        return method


@register("brute_force")
class BruteForcePolicy(SchedulerPolicy):
    """Un-pruned, un-ordered tree search (Table III benchmark)."""

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        sel, stats = dftsp_schedule(env, queue, prune=False,
                                    order_desc=False, fast_z_bound=False)
        return Decision.single(sel, stats)


@register("stb")
class StaticBatchingPolicy(SchedulerPolicy):
    """StB: FIFO admission up to the offline worst-case batch size."""

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        sel, stats = _legacy.static_batching(env, queue)
        return Decision.single(sel, stats)

    def batch_size(self, env: EdgeEnv) -> int:
        """The memoized offline batch size this policy admits up to."""
        return _legacy.static_batch_size(env)


@register("nob")
class NoBatchingPolicy(SchedulerPolicy):
    """NoB: one request per accelerator unit.  Its oracle is per-unit
    (1/n_units of compute+memory, true prompt length), NOT batched P1."""

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        sel, stats = _legacy.no_batching(env, queue)
        return Decision.single(sel, stats)

    def validate(self, env: EdgeEnv, decision: Decision) -> bool:
        return _legacy.nob_feasible(env, decision.selected)


@register("greedy")
class GreedyPolicy(SchedulerPolicy):
    """Slack-then-cost greedy admission (beyond-paper heuristic anchor)."""

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        sel, stats = _legacy.greedy(env, queue)
        return Decision.single(sel, stats)


class CallablePolicy(SchedulerPolicy):
    """Adapter for legacy ``(env, requests) -> (selected, stats)``
    callables (e.g. the capped searchers in benchmarks/table3)."""

    name = "callable"

    def __init__(self, fn: _legacy.Scheduler,
                 oracle: Optional[Callable[[EdgeEnv, Sequence[Request]],
                                           bool]] = None):
        self.fn = fn
        self.oracle = oracle

    def schedule(self, env: EdgeEnv, queue: Sequence[Request]) -> Decision:
        sel, stats = self.fn(env, queue)
        return Decision.single(sel, stats)

    def validate(self, env: EdgeEnv, decision: Decision) -> bool:
        if self.oracle is not None:
            return self.oracle(env, decision.selected)
        return problem.feasible(env, decision.selected)

    @property
    def spec(self) -> str:
        return f"callable:{getattr(self.fn, '__name__', repr(self.fn))}"


# ---------------------------------------------------------------------------
# Multi-LLM joint policy (first-class, same registry/runtime as the rest)
# ---------------------------------------------------------------------------


@register("multi-dftsp")
class MultiDftspPolicy(SchedulerPolicy):
    """Joint DFTSP over a MultiLLMEnv's hosted models (residual budgets,
    sequential compute slot).  ``order`` picks the model visit order;
    ``quant="auto"`` selects each hosted model's method per epoch."""

    def __init__(self, order: str = "weight", quant: str = "env",
                 split: bool = False):
        if order not in ("weight", "name", "load"):
            raise ValueError(f"unknown model order {order!r} "
                             "(expected weight|name|load)")
        if split and quant != "auto":
            raise ValueError("split=true needs quant=auto — a split epoch "
                             "is a choice BETWEEN methods per sub-batch")
        self.order = order
        self.quant = quant
        self.split = split
        self._swap_record: Optional[Dict] = None
        if quant != "auto":
            _resolve_quant_param(quant)     # fail fast on bad names

    def schedule(self, menv: "_multi.MultiLLMEnv",
                 queue: Sequence[Request]) -> Decision:
        if self.split:
            batches, quants, splits, stats = \
                _multi.multi_dftsp_assign_split(
                    menv, queue, order=self.order, quant=self.quant,
                    swap_record=self._swap_record)
            return Decision(batches=dict(batches), stats=stats,
                            quants=dict(quants), splits=dict(splits))
        batches, quants, stats = _multi.multi_dftsp_assign(
            menv, queue, order=self.order, quant=self.quant)
        if self.quant == "env":
            quants = {}         # deployment defaults: record no override
        return Decision(batches=dict(batches), stats=stats,
                        quants=dict(quants))

    def validate(self, menv: "_multi.MultiLLMEnv",
                 decision: Decision) -> bool:
        return _multi.multi_feasible(menv, decision.batches,
                                     order=self.order,
                                     quants=decision.quants,
                                     splits=decision.splits,
                                     swap_record=self._swap_record)

    def install_measured(self, methods: Dict[str, QuantMethod]) -> None:
        """Engine-measured QuantMethod records for the per-cohort auto
        descent (same contract as DftspPolicy.install_measured)."""
        self._measured = dict(methods)

    def install_swap_costs(self, record: Optional[Dict]) -> None:
        """Measured weight-swap record for split pricing (same contract
        as DftspPolicy.install_swap_costs)."""
        self._swap_record = dict(record) if record else None

    def select_quant(self, menv: "_multi.MultiLLMEnv",
                     model_id: Optional[str],
                     batch: Sequence[Request]) -> Optional[QuantMethod]:
        """Per-cohort method for the continuous path: the PR-2 descent on
        this model's single-model view (the joint budgets are enforced by
        the admission oracle, not here)."""
        if self.quant == "env" or not batch:
            return None
        if self.quant != "auto":
            return get_method(self.quant)
        measured = getattr(self, "_measured", None)
        _, method, _ = dftsp_schedule_auto(
            menv.envs[model_id], list(batch),
            methods=None if measured is None else list(measured.values()))
        return method


# ---------------------------------------------------------------------------
# Coercion from the legacy surface
# ---------------------------------------------------------------------------

_LEGACY_FN_SPECS = {
    _legacy.dftsp: "dftsp",
    _legacy.brute_force: "brute_force",
    _legacy.static_batching: "stb",
    _legacy.no_batching: "nob",
    _legacy.greedy: "greedy",
}


def as_policy(obj: Union[str, SchedulerPolicy, _legacy.Scheduler]
              ) -> SchedulerPolicy:
    """Coerce specs, policy objects, and legacy scheduler callables.

    Known legacy functions map (by identity, not name) to their registered
    policy class so e.g. ``no_batching`` keeps its per-unit oracle; unknown
    callables get the default P1 oracle via ``CallablePolicy``.
    """
    if isinstance(obj, SchedulerPolicy):
        return obj
    if isinstance(obj, str):
        return get_policy(obj)
    if callable(obj):
        known = _LEGACY_FN_SPECS.get(obj)
        return get_policy(known) if known else CallablePolicy(obj)
    raise TypeError(f"cannot build a SchedulerPolicy from {obj!r}")

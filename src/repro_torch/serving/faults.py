"""Deterministic fault injection for the serving data plane (§2.4).

A :class:`FaultPlan` is a SEEDED description of what goes wrong:
transient step exceptions, slow segments, and windows during which the
node's KV arena runs short of free pages.  :class:`FaultyExecutor`
wraps any executor (continuous ``step`` or epoch ``execute``) and
injects the plan; the runtimes answer with retry-with-backoff, a
watchdog around the step, cohort quarantine, and load shedding — all
with explicit accounting (``EpochMetrics.faults_injected`` /
``retried`` / ``watchdog_trips`` / ``quarantined`` / ``shed``).

The injection contract that makes fault runs TESTABLE: a transient
fault raises BEFORE the inner executor runs, so the wrapped step
mutates nothing — a retried step replays the exact same computation,
and a transient-only plan leaves every served token bit-identical to
the fault-free run (tests/test_slo_faults.py).  The wrapper draws from
its OWN rng, never the executor's, so the data plane's random stream
(synth prompts) is untouched by injection."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


class TransientStepError(RuntimeError):
    """A transient data-plane failure (injected or real), raised BEFORE
    the step mutated any state — safe to retry.  ``mid`` attributes the
    failure to one hosted pool for quarantine accounting (``None`` is
    the single-model pool's key, not "unattributed")."""

    def __init__(self, message: str, mid: Optional[str] = None):
        super().__init__(message)
        self.mid = mid


@dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule.

    ``p_transient`` — per-step probability of a :class:`TransientStepError`
    (capped at ``max_transient`` total).  ``p_slow``/``slow_s`` — per-step
    probability of an injected stall of ``slow_s`` wall seconds (trips
    the runtime watchdog when one is armed).  ``arena_holds`` — page
    squeeze windows ``(start_step, n_steps, n_pages)``: during the
    window up to ``n_pages`` of the node arena's free list are leased
    and held by the injector, so admission control sees a shrunken pool
    (and must defer, not crash); the pages are returned when the window
    closes.  The same (plan, seed) always injects the same schedule."""
    seed: int = 0
    p_transient: float = 0.0
    max_transient: Optional[int] = None
    p_slow: float = 0.0
    slow_s: float = 0.0
    arena_holds: tuple = ()        # ((start_step, n_steps, n_pages), ...)


class FaultyExecutor:
    """Transparent executor proxy that injects a :class:`FaultPlan`.

    Wraps a ``ContinuousExecutor`` (intercepting ``step``) or an epoch
    ``Executor`` (intercepting ``execute``); every other attribute —
    pools, admission gates, preemption, token collection — passes
    through to the wrapped executor untouched, so the runtimes drive a
    faulty executor exactly like a healthy one."""

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._step_no = 0
        self._held: dict = {}      # window index -> held page leases
        self.injected = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- injection -----------------------------------------------------------

    def _squeeze_arena(self, i: int) -> None:
        arena = getattr(self._inner, "arena", None)
        if arena is None:
            return
        for w, (start, n_steps, n_pages) in enumerate(self.plan.arena_holds):
            if start <= i < start + n_steps and w not in self._held:
                take = min(int(n_pages), arena.free_pages)
                if take > 0:
                    self._held[w] = arena.alloc(take)
            elif i >= start + n_steps and w in self._held:
                arena.free(self._held.pop(w))

    def _maybe_inject(self, what: str) -> None:
        """One injection decision; raises on a transient fault.  Drawn
        from the wrapper's own rng — a retry of the SAME boundary draws
        the next schedule entry (so a retry can re-fault), and the inner
        executor's stream is never advanced by injection."""
        plan = self.plan
        if plan.p_slow > 0 and self._rng.uniform() < plan.p_slow:
            time.sleep(plan.slow_s)
        if plan.p_transient > 0 \
                and (plan.max_transient is None
                     or self.injected < plan.max_transient) \
                and self._rng.uniform() < plan.p_transient:
            self.injected += 1
            pools = getattr(self._inner, "pool_ids", lambda: [None])()
            mid = pools[int(self._rng.integers(len(pools)))] if pools \
                else None
            raise TransientStepError(
                f"injected transient fault ({what} #{self._step_no})",
                mid=mid)

    # -- intercepted entry points -------------------------------------------

    def step(self, env, k):
        i = self._step_no
        self._step_no += 1
        self._squeeze_arena(i)
        self._maybe_inject("step")
        return self._inner.step(env, k)

    def execute(self, env, decision):
        self._step_no += 1
        self._maybe_inject("execute")
        return self._inner.execute(env, decision)

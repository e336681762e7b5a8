"""SLO machinery for the continuous loop (DESIGN.md §2.4).

Three pieces, all control-plane-side and executor-agnostic:

  * ``edf_order`` — the admission ordering: Earliest-Deadline-First
    WITHIN a priority class, higher classes first.  FIFO (arrival order)
    stays available through ``ContinuousRuntime(admission="fifo")`` for
    the A/B the SLO benchmark runs.
  * ``SpillRecord`` — the host-side progress record of a preempted
    request: what must survive eviction so the request can resume with
    its already-delivered prefix intact (the executor-specific payload),
    plus the attempt cap and boundary backoff that keep preemption from
    thrashing.
  * ``DegradationController`` — the graceful-degradation hysteresis:
    under sustained queue pressure or sagging SLO attainment the runtime
    enters degraded mode (cohorts start at the FASTEST admissible
    quantization method, lowest-priority queued work is shed), and exits
    only after the pressure clears for ``patience`` consecutive
    boundaries — enter/exit thresholds are separated so the controller
    cannot oscillate on a queue hovering at one threshold.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.request import Request


def edf_order(queue: Sequence[Request]) -> List[Request]:
    """Admission order: priority classes high→low, Earliest Deadline
    First within a class, arrival then rid as deterministic tiebreaks."""
    return sorted(queue, key=lambda r: (-r.priority, r.deadline,
                                        r.arrival, r.rid))


def pick_victim(residents: Sequence[Request],
                candidate: Request) -> Optional[Request]:
    """The resident row ``candidate`` may evict, or None.

    A candidate beats a victim iff it is of a STRICTLY higher priority
    class, or of the same class with a strictly earlier deadline — so
    preemption only ever trades a looser deadline for a tighter one and
    two equal requests can never evict each other (no livelock).  Among
    beatable residents the cheapest victim is chosen: lowest priority
    first, latest deadline second."""
    beatable = [v for v in residents
                if candidate.priority > v.priority
                or (candidate.priority == v.priority
                    and candidate.deadline < v.deadline)]
    if not beatable:
        return None
    return min(beatable, key=lambda v: (v.priority, -v.deadline, v.rid))


@dataclass
class SpillRecord:
    """Host-side survival record of a preempted request.

    ``payload`` is the executor's opaque resume token — the analytic
    executor spills ``{"remaining": tokens_left}``, the engine executor
    spills ``{"prompt": [...], "prefix": [...]}`` (the ORIGINAL prompt it
    must re-prefill plus the already-delivered tokens it must replay
    bit-exactly through the engine's forced-prefix mechanism).
    ``attempts`` caps how often the same request may be evicted
    (``ContinuousRuntime.max_preemptions``), and ``not_before`` is the
    global boundary index before which the spilled request is NOT
    re-admitted — a linear backoff (attempts × backoff_boundaries) that
    keeps a preempt/resume pair from ping-ponging every boundary."""
    request: Request
    payload: dict
    attempts: int = 1
    not_before: int = 0


@dataclass
class DegradationController:
    """Hysteresis controller for graceful degradation (DESIGN.md §2.4).

    ``observe`` is called once per segment boundary with the current
    queue depth and the SLO attainment over the last ``window`` finishes
    (None until anything finished).  Pressure = queue depth at or above
    ``queue_high``, or recent attainment below ``attain_floor``.  The
    controller flips to degraded only after ``patience`` CONSECUTIVE
    pressured boundaries, and recovers only after ``patience``
    consecutive boundaries with the queue back at or below ``queue_low``
    and attainment restored over at least ``min_samples`` DEGRADED-ERA
    finishes (the window is cleared on entry; an empty window is not
    recovery evidence) — the enter/exit thresholds are deliberately
    separated (queue_high > queue_low) so a queue hovering at one
    threshold cannot make the controller oscillate."""
    queue_high: int = 12          # enter pressure at/above this depth
    queue_low: int = 4            # exit pressure requires at/below this
    attain_floor: float = 0.9     # recent-attainment pressure threshold
    patience: int = 2             # consecutive boundaries before flipping
    window: int = 64              # finishes in the attainment window
    min_samples: int = 1          # degraded-era finishes required before
                                  # the exit streak may count — recovery
                                  # is judged on evidence, never on an
                                  # empty window
    shed_below_priority: int = 0  # degraded mode sheds queued work with
                                  # priority < this (0 = never shed)
    degraded: bool = False
    _enter_streak: int = field(default=0, repr=False)
    _exit_streak: int = field(default=0, repr=False)
    _recent: deque = field(default_factory=deque, repr=False)

    def record_finish(self, met_slo: bool) -> None:
        self._recent.append(bool(met_slo))
        while len(self._recent) > self.window:
            self._recent.popleft()

    @property
    def recent_attainment(self) -> Optional[float]:
        if not self._recent:
            return None
        return sum(self._recent) / len(self._recent)

    def observe(self, queue_len: int) -> bool:
        """Advance the hysteresis one boundary; returns the (possibly
        flipped) degraded flag."""
        att = self.recent_attainment
        pressured = queue_len >= self.queue_high \
            or (att is not None and att < self.attain_floor)
        relaxed = queue_len <= self.queue_low \
            and (att is None or att >= self.attain_floor)
        if self.degraded:
            # ``_recent`` was cleared on entry, so ``att is None`` here
            # means NOTHING finished in the degraded era — an empty
            # window is no evidence of recovery.  Exit requires at least
            # ``min_samples`` degraded-era finishes, all meeting the
            # attainment floor on average (the documented "judge
            # recovery on degraded-era finishes" contract).
            relaxed = relaxed and att is not None \
                and len(self._recent) >= max(1, self.min_samples)
        if not self.degraded:
            self._enter_streak = self._enter_streak + 1 if pressured else 0
            if self._enter_streak >= self.patience:
                self.degraded = True
                self._enter_streak = 0
                self._recent.clear()   # judge recovery on degraded-era
                                       # finishes, not the backlog's
        else:
            self._exit_streak = self._exit_streak + 1 if relaxed else 0
            if self._exit_streak >= self.patience:
                self.degraded = False
                self._exit_streak = 0
        return self.degraded

    def shed_candidates(self, queue: Sequence[Request]) -> List[Request]:
        """The queued requests degraded mode sheds: strictly below the
        configured priority floor — lowest-priority work goes first and
        work at/above the floor is never shed."""
        if not self.degraded or self.shed_below_priority <= 0:
            return []
        return [r for r in queue if r.priority < self.shed_below_priority]

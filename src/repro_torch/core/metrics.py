"""Unified epoch-protocol metrics (analytic sim AND real-engine serving).

``EpochMetrics`` replaced the two historical records — ``SimResult``
(analytic) and ``ServeTrace`` (real engine) — which disagreed on units.
``throughput`` is requests/second everywhere (the paper's objective).
The deprecated shim modules (``core/epoch.py``, ``serving/simulator.py``)
and their aliases are gone; drive ``EpochRuntime`` directly.

Per-epoch accounting lives in ``traces`` so executor-equivalence tests can
compare scheduling decisions epoch by epoch, not just aggregates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method) without
    importing numpy for a metrics record; 0.0 on an empty sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


@dataclass
class EpochTrace:
    """One epoch of the runtime loop (warmup epochs have counted=False).

    ``quants`` records the quantization method the control plane decided
    for each served model this epoch (``{model_id: method_name}``; the
    ``None`` key on a single-model node) — empty when nothing was served.
    ``wall_s`` is the measured wall-clock of this epoch's
    ``executor.execute`` call — the data plane's real execution time under
    ``EngineExecutor``; under the analytic executor (which charges
    cost-model time and runs nothing) it is just microseconds of Python
    overhead, so use ``tokens_per_s``/``generated_tokens`` (0 for
    analytic) to tell the paths apart, not ``wall_s``.

    Continuous-batching epochs (``ContinuousRuntime``) additionally
    record their segment structure: ``segments`` chunked-decode segments
    ran this epoch, ``occupancy`` is the occupied-slot fraction during
    each of them, ``admitted_mid_epoch`` counts admissions at interior
    segment boundaries (the requests an epoch-boundary protocol would
    have left queued), and ``finished_rids`` the requests whose
    generation COMPLETED this epoch (``selected_rids`` holds admissions).
    All four stay empty/0 under the epoch-boundary runtime.
    """
    epoch: int
    arrived: int
    dropped: int
    selected_rids: List[int]
    truncated: int = 0
    nodes_visited: int = 0
    generated_tokens: int = 0
    counted: bool = True
    quants: Dict[Optional[str], str] = field(default_factory=dict)
    wall_s: float = 0.0
    segments: int = 0
    admitted_mid_epoch: int = 0
    occupancy: List[float] = field(default_factory=list)
    finished_rids: List[int] = field(default_factory=list)
    # KV-block accounting (continuous path, DESIGN.md §2.3): blocks in
    # use after each of this epoch's segments, against the node total.
    # Slot-level for data planes without a physical block pool; true
    # arena pages under the paged engine executor.
    kv_blocks_in_use: List[int] = field(default_factory=list)
    kv_blocks_total: int = 0
    # SLO / robustness accounting (continuous path, DESIGN.md §2.4)
    preempted_rids: List[int] = field(default_factory=list)
    shed_rids: List[int] = field(default_factory=list)
    faults: int = 0               # transient step faults hit this epoch

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput of this epoch's real execution (0 if nothing
        ran or nothing was generated)."""
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0


@dataclass
class EpochMetrics:
    n_epochs: int
    T_E: float
    served: int = 0
    dropped: int = 0
    arrived: int = 0
    truncated: int = 0            # scheduled but spilled past engine capacity
    generated_tokens: int = 0     # real-engine paths only (0 for analytic)
    wall_s: float = 0.0           # summed execute() wall-clock (counted
                                  # epochs; ~0 but nonzero for analytic)
    batch_sizes: List[int] = field(default_factory=list)
    nodes_visited: int = 0
    leaves_checked: int = 0
    served_by_method: Dict[str, int] = field(default_factory=dict)
    served_by_model: Dict[Optional[str], int] = field(default_factory=dict)
                                  # requests served per hosted model
                                  # (key None on a single-model node) —
                                  # the per-model split the multi-LLM
                                  # benchmarks report
    traces: List[EpochTrace] = field(default_factory=list)
    segments: int = 0             # chunked segments run (continuous path)
    admitted_mid_epoch: int = 0   # admissions at interior segment
                                  # boundaries (continuous path; 0 under
                                  # the epoch-boundary runtime)
    final_queue_rids: List[int] = field(default_factory=list)
                                  # requests still queued when the run
                                  # ended (conservation accounting:
                                  # arrived == served + dropped + queued
                                  # for warmup_epochs=0 runs)
    kv_alloc_tokens: int = 0      # Σ per-segment allocated KV tokens
                                  # (pages_in_use × block_tokens under
                                  # the arena; 0 without block
                                  # accounting)
    kv_dead_tokens: int = 0       # Σ per-segment allocated-but-dead KV
                                  # tokens (junk gaps + reserved tail)
    kv_topup_pages: int = 0       # pages leased via segment-boundary
                                  # lease top-ups (cap-aware incremental
                                  # leasing, DESIGN.md §2.3) this run
    # -- SLO accounting (DESIGN.md §2.4) ------------------------------------
    shed: int = 0                 # load-shed under pressure/quarantine
                                  # (distinct from viability drops)
    preempted: int = 0            # resident rows evicted at a boundary
    resumed: int = 0              # preempted rows re-admitted
    retried: int = 0              # executor step/execute retries after
                                  # transient faults
    slo_met: int = 0              # served requests finishing by deadline
    latencies: List[float] = field(default_factory=list)
                                  # completion - arrival per served req
    ttfts: List[float] = field(default_factory=list)
                                  # first-token time - arrival per served
    tpots: List[float] = field(default_factory=list)
                                  # (completion - first token) / tokens
    in_flight_rids: List[int] = field(default_factory=list)
                                  # resident when the run ENDED — empty
                                  # after a clean drain; populated on the
                                  # partial metrics a DrainStallError
                                  # carries
    # -- fault / degradation accounting -------------------------------------
    faults_injected: int = 0      # transient step faults seen
    watchdog_trips: int = 0       # step calls exceeding the watchdog
    quarantined: List[str] = field(default_factory=list)
                                  # pools quarantined after N consecutive
                                  # step failures
    degraded_segments: int = 0    # segments run in degraded mode
    requanted: int = 0            # LIVE cohorts re-pointed at a degraded
                                  # method on a degradation rising edge
                                  # (mid-flight requant, DESIGN.md §2.4)

    @property
    def throughput(self) -> float:
        """Requests served per second (paper objective) — in BOTH the
        analytic and the real-engine path."""
        return self.served / max(self.n_epochs * self.T_E, 1e-12)

    @property
    def tokens_per_s(self) -> float:
        """Measured decode throughput of the real data plane: generated
        tokens per second of executor wall-clock (0 for analytic runs)."""
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_batch(self) -> float:
        bs = self.batch_sizes
        return sum(bs) / len(bs) if bs else 0.0

    @property
    def mean_occupancy(self) -> float:
        """Mean occupied-slot fraction across counted continuous-batching
        segments (0.0 under the epoch-boundary runtime)."""
        occ = [o for t in self.traces if t.counted for o in t.occupancy]
        return sum(occ) / len(occ) if occ else 0.0

    @property
    def mean_block_occupancy(self) -> float:
        """Mean KV-blocks-in-use fraction across counted continuous
        segments (DESIGN.md §2.3).  Slot-level (== occupancy) for data
        planes without a block pool; true page occupancy under the
        paged arena — the number ``benchmarks/paged_vs_slab.py`` gates
        against the slab baseline."""
        fracs = [u / t.kv_blocks_total for t in self.traces
                 if t.counted and t.kv_blocks_total
                 for u in t.kv_blocks_in_use]
        return sum(fracs) / len(fracs) if fracs else 0.0

    @property
    def fragmentation(self) -> float:
        """Allocated-but-dead KV tokens over allocated KV tokens (0
        without block accounting): junk-gap and reserved-tail volume
        inside leased pages."""
        return self.kv_dead_tokens / self.kv_alloc_tokens \
            if self.kv_alloc_tokens else 0.0

    # -- SLO views ----------------------------------------------------------

    @property
    def slo_attainment(self) -> float:
        """Fraction of ARRIVED requests served by their deadline — misses,
        drops, and shed work all count against attainment (serving 1 of
        100 on time is not 100% attainment)."""
        return self.slo_met / self.arrived if self.arrived else 0.0

    @property
    def p50_latency(self) -> float:
        return percentile(self.latencies, 50.0)

    @property
    def p99_latency(self) -> float:
        return percentile(self.latencies, 99.0)

    @property
    def p50_ttft(self) -> float:
        return percentile(self.ttfts, 50.0)

    @property
    def p99_ttft(self) -> float:
        return percentile(self.ttfts, 99.0)

    @property
    def mean_tpot(self) -> float:
        return sum(self.tpots) / len(self.tpots) if self.tpots else 0.0

    @property
    def methods_served(self) -> List[str]:
        """Distinct quantization methods that served requests, most-used
        first (adaptive-precision runs list more than one)."""
        return sorted(self.served_by_method,
                      key=lambda k: (-self.served_by_method[k], k))

    # -- ServeTrace compatibility -------------------------------------------

    @property
    def epochs(self) -> int:
        return self.n_epochs

    @property
    def batches(self) -> List[int]:
        return self.batch_sizes

    def row(self) -> Dict[str, float]:
        return {"throughput": self.throughput, "served": self.served,
                "dropped": self.dropped, "arrived": self.arrived,
                "mean_batch": self.mean_batch,
                "nodes": self.nodes_visited}

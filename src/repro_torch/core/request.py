"""User inference requests  <s_i, n_i, tau_i, a_i>  (paper §II)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

BYTES_PER_TOKEN = 2       # BPE token index, 2-byte (paper §IV)
BITS_PER_TOKEN = 16


@dataclass
class Request:
    rid: int
    s: int                 # input prompt length (tokens)
    n: int                 # maximum output length (tokens), one of the levels
    tau: float             # latency requirement (seconds)
    a: float               # required accuracy (in [0,1]; needs a <= f(dPPL))
    h: float               # channel gain (amplitude)
    arrival: float = 0.0   # arrival time (seconds)
    t_w: float = 0.0       # waiting time at scheduling (seconds)
    model_id: Optional[str] = None   # hosted model this request targets
                                     # (None on a single-LLM node)
    priority: int = 0      # SLO priority class (larger = more important;
                           # EDF orders within a class, and preemption
                           # only ever evicts a strictly lower class)

    @property
    def deadline(self) -> float:
        """Absolute completion deadline: the paper's per-user latency
        constraint (1d) anchored at arrival."""
        return self.arrival + self.tau


@dataclass
class RequestGenerator:
    """Poisson arrivals with the paper's §IV marginals.

    ``priorities`` optionally assigns each arrival an SLO priority class
    (uniform over the levels).  The default single level draws NOTHING
    from the rng, so pre-SLO streams stay bit-identical.
    """
    rate: float                            # requests / second
    lengths: tuple = (128, 256, 512)       # input & output token levels
    tau_range: tuple = (0.5, 2.0)
    acc_range: tuple = (0.0, 1.0)
    path_loss: float = 1e-3                # Rayleigh fading scale (power)
    seed: int = 0
    priorities: tuple = (0,)               # SLO priority levels to sample
    _rng: np.random.Generator = field(init=False, repr=False, default=None)
    _next_id: int = field(init=False, default=0)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def within(self, t0: float, t1: float) -> list:
        """Generate arrivals in [t0, t1)."""
        rng = self._rng
        n = rng.poisson(self.rate * (t1 - t0))
        times = np.sort(rng.uniform(t0, t1, size=n))
        out = []
        for t in times:
            # Rayleigh amplitude with E[h^2] = path_loss
            h = float(rng.rayleigh(scale=np.sqrt(self.path_loss / 2.0)))
            out.append(Request(
                rid=self._next_id,
                s=int(rng.choice(self.lengths)),
                n=int(rng.choice(self.lengths)),
                tau=float(rng.uniform(*self.tau_range)),
                a=float(rng.uniform(*self.acc_range)),
                h=h,
                arrival=float(t),
                priority=int(rng.choice(self.priorities))
                if len(self.priorities) > 1 else int(self.priorities[0])))
            self._next_id += 1
        return out


@dataclass
class ReplayGenerator:
    """Replays a FROZEN arrival stream through the ``within`` interface.

    Lets two runtimes that slice time differently (the epoch-boundary
    loop queries whole epochs, the continuous loop queries segment
    windows) see the IDENTICAL traffic realization — the like-for-like
    requirement of the continuous-vs-epoch comparison.  Each ``within``
    call returns fresh copies, so runs never share mutable Request state
    (``t_w``/``model_id``).
    """
    requests: Sequence[Request]

    @classmethod
    def poisson(cls, rate: float, horizon: float, seed: int = 0,
                **kw) -> "ReplayGenerator":
        """Freeze one Poisson stream over ``[0, horizon)``."""
        gen = RequestGenerator(rate=rate, seed=seed, **kw)
        return cls(requests=gen.within(0.0, horizon))

    def within(self, t0: float, t1: float) -> list:
        return [dataclasses.replace(r) for r in self.requests
                if t0 <= r.arrival < t1]


@dataclass
class BurstyGenerator:
    """Bursty/diurnal arrivals: a non-homogeneous Poisson process, FROZEN
    at construction and replayed through ``within`` — the same
    freeze-and-replay contract as :class:`ReplayGenerator`, so the
    epoch-boundary and continuous protocols (which slice time
    differently) see the IDENTICAL bursty traffic realization.

    The instantaneous rate is the base rate modulated by a diurnal
    sinusoid plus rectangular burst windows::

        rate(t) = base_rate * (1 + depth * sin(2*pi*t / period))
                            * mult(t)        # mult from overlapping bursts

    with ``bursts`` a sequence of ``(t_start, duration, multiplier)``.
    The stream is drawn by thinning a homogeneous process at the peak
    rate, so the SAME parameters always freeze the SAME stream — the
    determinism the SLO benchmark's committed artifact relies on.
    Marginals (lengths, tau, accuracy, fading, priorities) follow
    :class:`RequestGenerator`.
    """
    base_rate: float
    horizon: float
    seed: int = 0
    period: float = 16.0
    depth: float = 0.5
    bursts: tuple = ()                     # ((t_start, duration, mult), ...)
    lengths: tuple = (128, 256, 512)
    tau_range: tuple = (0.5, 2.0)
    acc_range: tuple = (0.0, 1.0)
    path_loss: float = 1e-3
    priorities: tuple = (0,)
    requests: list = field(init=False, repr=False, default=None)

    def rate_at(self, t: float) -> float:
        mult = 1.0
        for t0, dur, m in self.bursts:
            if t0 <= t < t0 + dur:
                mult *= m
        return self.base_rate * (1.0 + self.depth
                                 * np.sin(2.0 * np.pi * t / self.period)) \
            * mult

    def _peak_rate(self) -> float:
        peak_mult = 1.0
        for _, _, m in self.bursts:
            peak_mult = max(peak_mult, peak_mult * max(1.0, m))
        return self.base_rate * (1.0 + abs(self.depth)) * peak_mult

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        lam = self._peak_rate()
        n = rng.poisson(lam * self.horizon)
        times = np.sort(rng.uniform(0.0, self.horizon, size=n))
        keep = rng.uniform(size=n)          # thinning draws, one per point
        self.requests = []
        rid = 0
        for t, u in zip(times, keep):
            if u * lam > self.rate_at(float(t)):
                continue
            h = float(rng.rayleigh(scale=np.sqrt(self.path_loss / 2.0)))
            self.requests.append(Request(
                rid=rid,
                s=int(rng.choice(self.lengths)),
                n=int(rng.choice(self.lengths)),
                tau=float(rng.uniform(*self.tau_range)),
                a=float(rng.uniform(*self.acc_range)),
                h=h,
                arrival=float(t),
                priority=int(rng.choice(self.priorities))))
            rid += 1

    def within(self, t0: float, t1: float) -> list:
        return [dataclasses.replace(r) for r in self.requests
                if t0 <= r.arrival < t1]

"""The one traffic generator: a mix file's parameters to requests.

Open-loop Poisson arrivals on the serving runtime's own clock with the
paper's marginals (prompt and output lengths drawn from ``lengths``, a
latency limit from U(tau_range), a required accuracy from U(acc_range),
a Rayleigh channel of mean power ``path_loss``), drawn from one numpy
generator seeded with ``--seed``.  The runtime asks for the arrivals of
each interval in turn (``within``), as it asks its own generator; the
requests are the program's ``Request`` records, its input type.

The generator is the benchmark's own copy of the program's
``RequestGenerator.within`` (one priority level): traffic generation is
part of the yardstick, which a change to the program may not move.  For
the same parameters and seed the two give the same stream.

A mix file (``perfbench/traffic/<name>.json``) holds::

    {"arrivals": {"kind": "poisson", "rate": <requests/s>,
                  "lengths": [...], "tau_range": [lo, hi],
                  "acc_range": [lo, hi], "path_loss": <float>},
     "policy": "<policy registry spec>",
     "runtime": {"kind": "epoch"} or
                {"kind": "continuous", "k": <steps a segment>,
                 "arena": {"block_tokens": <int>, "shrink": <float>}},
     "sample": <requests compared with the reference>,
     "profile_calls": <data-plane calls the traced run profiles>}
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.request import Request


class PoissonTraffic:
    """Poisson arrivals with the paper's §IV marginals."""

    def __init__(self, params: Dict, seed: int):
        if params.get("kind", "poisson") != "poisson":
            raise ValueError(f"unknown arrivals kind {params['kind']!r}")
        self.rate = float(params["rate"])
        self.lengths = tuple(int(n) for n in params["lengths"])
        self.tau_range = tuple(params["tau_range"])
        self.acc_range = tuple(params["acc_range"])
        self.path_loss = float(params["path_loss"])
        self.rng = np.random.default_rng(int(seed))
        self.next_id = 0

    def within(self, t0: float, t1: float) -> List[Request]:
        """The arrivals in [t0, t1), in order of arrival."""
        rng = self.rng
        n = rng.poisson(self.rate * (t1 - t0))
        out = []
        for t in np.sort(rng.uniform(t0, t1, size=n)):
            h = float(rng.rayleigh(scale=np.sqrt(self.path_loss / 2.0)))
            out.append(Request(
                rid=self.next_id, s=int(rng.choice(self.lengths)),
                n=int(rng.choice(self.lengths)),
                tau=float(rng.uniform(*self.tau_range)),
                a=float(rng.uniform(*self.acc_range)), h=h,
                arrival=float(t)))
            self.next_id += 1
        return out

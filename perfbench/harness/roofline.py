"""A kernel's share of its roofline in the traced sub-window.

The least time of the sub-window's calls of the kernel (each call's
bound is the larger of its operations over the peak and its bytes over
the memory bandwidth, from ``perfbench/costs/``), over the device time
the trace gives those calls.  The calls are worked out from the
data-plane calls the sub-window profiled (their decode steps, prefills
and captures) and the configuration's shapes; their number has to equal
the trace's count of the kernel's last device function, or the share is
not reported (its time could not be attributed)."""
from __future__ import annotations

import sys
from typing import Iterable, Optional, Tuple

from perfbench.harness.peaks import bound_s


def share(run, kernel, calls: Iterable[Tuple[float, float]],
          n_calls: int) -> Optional[float]:
    """``calls``: (ops, bytes) of every call; ``n_calls`` their number."""
    if not run.kernels:
        return None
    t, counts = run.kernel_time_s(kernel.KERNELS)
    if counts[kernel.LAST] != n_calls or t <= 0:
        print(f"roofline of {kernel.__name__}: the trace holds "
              f"{counts} events, the sub-window's calls are {n_calls}; "
              f"not reported", file=sys.stderr)
        return None
    least = sum(bound_s(ops, nb) for ops, nb in calls)
    return 100.0 * least / t


def decode_steps(run):
    """(t, count) of every decode step the sub-window ran: each
    data-plane call's device-loop steps, from the cohort step ``t0``, and
    the one step a capture runs before it records (at the cohort's first
    step)."""
    out = []
    for c in run.profiled:
        for t0, n in c["steps"]:
            out.extend(range(t0, t0 + n))
        out.extend([0] * c["captures"])
    return out

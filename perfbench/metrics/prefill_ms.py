"""The device's ms a prefill: the median of the program's ``dev.prefill``
intervals (CUDA events around the host->device copy, the prefill and
its scatter or splice) in the window, outside the profiled
sub-window."""
import statistics

from perfbench.harness.program_trace import window


def read(run):
    w = window(run)
    if w is None:
        return None
    ms = [1e3 * (r.t1 - r.t0) for r in w.intervals
          if r.name == "dev.prefill" and w.inside(r.t0, r.t1)]
    return statistics.median(ms) if ms else None

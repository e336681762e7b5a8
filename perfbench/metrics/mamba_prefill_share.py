"""The share of the prefill's device time in the program's
``dev.prefill.mamba`` intervals (each Mamba2 mixer, CUDA events nested in
``dev.prefill``): their sum over the sum of the window's ``dev.prefill``
intervals, outside the profiled sub-window.  None where the program
records no such interval."""
from perfbench.harness.program_trace import window


def read(run):
    w = window(run)
    if w is None:
        return None
    total = part = 0.0
    for r in w.intervals:
        if not w.inside(r.t0, r.t1):
            continue
        if r.name == "dev.prefill":
            total += r.t1 - r.t0
        elif r.name == "dev.prefill.mamba":
            part += r.t1 - r.t0
    if total <= 0 or part <= 0:
        return None
    return 100.0 * part / total

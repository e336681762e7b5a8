"""The host's ms a capture of the decode step: the mean of the program's
``engine.capture`` spans (the warm-up step, the graph capture and the
device loop's build) in the window, outside the profiled sub-window."""
from perfbench.harness.program_trace import window


def read(run):
    w = window(run)
    if w is None:
        return None
    ms = [1e3 * (r.t1 - r.t0) for r in w.spans if r.name == "engine.capture"]
    return sum(ms) / len(ms) if ms else None

"""Kernel nodes of the captured decode step: the median over the
engine's captures of the run, those of set-up and of the window
(``engine.captures[i]["nodes"]``, read by the program after each
capture); None where nothing was captured (the CPU's eager loop)."""
import statistics


def read(run):
    nodes = [c["nodes"] for c in run.engine_info.get("captures", ())]
    if not nodes:
        return None
    return statistics.median(nodes)

"""The published Zamba2 decode step's share of its roofline: the least
time of the window's decode steps (``perfbench/costs/zamba2_step.py``,
each step at its valid length s' + t + 1, bound by the larger of its
operations over the bf16 peak and its bytes over the HBM bandwidth)
over their device time (the program's ``dev.decode`` intervals of the
window's unprofiled data-plane calls, as ``decode_step_ms`` reads
them).  None unless the program reported, at its captures, the SSM and
conv state bytes (``ssm_state_bytes``) that the count holds."""
import sys

from perfbench.costs import zamba2_step
from perfbench.harness.peaks import bound_s
from perfbench.harness.program_trace import window


def read(run):
    m, e = run.model, run.engine
    B = e["batch_capacity"]
    have = {c.get("ssm_state_bytes") for c in
            run.engine_info.get("captures", ())}
    want = zamba2_step.state_bytes(m, B)
    if have != {want}:
        print(f"zamba2_step_roofline: the program's state bytes {have}, "
              f"the count's {want}; not reported", file=sys.stderr)
        return None
    w = window(run)
    if w is None:
        return None
    calls = [c for c in w.calls()
             if c["iters"] and c["dev"].get("dev.decode")]
    if not calls:
        return None
    W = e["s_max"] + e["n_max"]
    least = sum(bound_s(*zamba2_step.cost(m, B, min(e["s_max"] + t + 1, W)))
                for c in calls for t in range(c["iters"]))
    return 100.0 * least / sum(c["dev"]["dev.decode"] for c in calls)

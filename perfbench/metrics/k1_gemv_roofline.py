"""K1's decode GEMV (``qmm_a16_gemv``): the share of its roofline over
the traced sub-window's decode steps."""
from perfbench.costs import k1_gemv
from perfbench.harness.roofline import decode_steps, share


def read(run):
    shapes = k1_gemv.step_shapes(run.model, run.engine_info["tier"] ==
                                 "fused")
    B = run.engine["batch_capacity"]
    steps = len(decode_steps(run))
    calls = [k1_gemv.cost(B, K, N) for K, N in shapes] * steps
    return share(run, k1_gemv, calls, len(calls))

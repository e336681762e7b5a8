"""K1's prefill matmul (``qmm_tc``): the share of its roofline over the
traced sub-window's prefills (batch capacity x s' rows each)."""
from perfbench.costs import qmm_tc
from perfbench.harness.roofline import share


def read(run):
    M = run.engine["batch_capacity"] * run.engine["s_max"]
    n = sum(c["prefills"] for c in run.profiled)
    calls = [qmm_tc.cost(M, K, N) for K, N in qmm_tc.prefill_shapes(
        run.model)] * n
    return share(run, qmm_tc, calls, len(calls))

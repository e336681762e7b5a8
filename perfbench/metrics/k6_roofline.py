"""K6 (the fused quantized decode attention over the slab): the share of
its roofline over the traced sub-window's decode steps, one call a
layer, each over the s' + t slots before the step's write."""
from perfbench.costs import k6
from perfbench.harness.roofline import decode_steps, share


def read(run):
    m, e = run.model, run.engine
    W = e["s_max"] + e["n_max"]
    calls = []
    for t in decode_steps(run):
        nv = min(e["s_max"] + t, W)
        calls += [k6.cost(e["batch_capacity"], m["d_model"], m["n_heads"],
                          m["n_kv_heads"], m["d_head"], nv)] * m["n_layers"]
    return share(run, k6, calls, len(calls))

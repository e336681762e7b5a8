"""K4 (split-KV decode attention over the slab): the share of its
roofline over the traced sub-window's decode steps, one call a layer,
each at the step's valid slots (s' + t + 1)."""
from perfbench.costs import k4
from perfbench.harness.roofline import decode_steps, share


def read(run):
    m, e = run.model, run.engine
    W = e["s_max"] + e["n_max"]
    calls = []
    for t in decode_steps(run):
        nv = min(e["s_max"] + t + 1, W)
        calls += [k4.cost(e["batch_capacity"], m["n_heads"],
                          m["n_kv_heads"], m["d_head"], nv)] * m["n_layers"]
    return share(run, k4, calls, len(calls))

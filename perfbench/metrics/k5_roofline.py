"""K5 (K4 through the arena's block table): the share of its roofline
over the traced sub-window's decode steps, one call a layer."""
from perfbench.costs import k5
from perfbench.harness.roofline import decode_steps, share


def read(run):
    m, e = run.model, run.engine
    W = e["s_max"] + e["n_max"]
    n_b = W // run.runtime["arena"]["block_tokens"]
    calls = []
    for t in decode_steps(run):
        nv = min(e["s_max"] + t + 1, W)
        calls += [k5.cost(e["batch_capacity"], m["n_heads"],
                          m["n_kv_heads"], m["d_head"], nv, n_b)] \
            * m["n_layers"]
    return share(run, k5, calls, len(calls))

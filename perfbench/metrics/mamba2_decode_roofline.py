"""``mamba2_decode`` (``mamba2_scan_step`` + ``mamba2_gate_norm``): the
share of its roofline over the traced sub-window's decode steps, one
call a Mamba2 layer a step (``perfbench/costs/mamba2_decode.py``).

A profiled call of this cell holds about 146k kernel records, and the
profiler drops some of them in about one traced run of three on an H100
(1 % and 6 % of this kernel's calls seen missing, both kernels alike).
Every call costs the same, so where the trace holds at least
``1 - DROPPED`` of the calls and the two kernels' counts lie within one
of each other, the share is read over the whole calls it holds; a larger
shortfall reports nothing."""
import sys

from perfbench.costs import mamba2_decode
from perfbench.harness.roofline import decode_steps, share

DROPPED = 0.5


def read(run):
    m, e = run.model, run.engine
    s = m["ssm"]
    d = s["expand"] * m["d_model"]
    one = mamba2_decode.cost(e["batch_capacity"], d // s["head_dim"],
                             s["head_dim"], s["d_state"], s["n_groups"],
                             s["conv_width"],
                             2 if m["dtype"] == "bfloat16" else 4)
    n = len(decode_steps(run)) * m["n_layers"]
    if run.kernels:
        _, counts = run.kernel_time_s(mamba2_decode.KERNELS)
        held = min(counts.values())
        if (1 - DROPPED) * n <= held < n \
                and max(counts.values()) - held <= 1:
            print(f"mamba2_decode_roofline: the trace holds {counts} of "
                  f"{n} calls; read over {held}", file=sys.stderr)
            n = held
    return share(run, mamba2_decode, [one] * n, n)

"""The whole serving step's share of the card's bf16 dense peak: the
model FLOPs of the served rows (prompt tokens at min(s, s') and
generated tokens, counted by the ``prompt_flops`` and ``tokens_flops``
of the cell's architecture module) over the traced run's window less
its profiled sub-window, over 989e12 FLOP/s."""
from perfbench.harness.peaks import BF16_FLOPS


def read(run):
    wall = run.host_window_s()
    flops = sum(c["flops"] for c in run.unprofiled)
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / wall / BF16_FLOPS

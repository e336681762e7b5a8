"""The share of the window's wall time outside the calls into the
engine's public entries (``generate``; ``start_chunked``,
``refill_chunked``, ``generate_chunked``, ``poll_chunked``), outside the
profiled sub-window."""
from perfbench.harness.drive import ENGINE_ENTRIES


def read(run):
    wall = run.host_window_s()
    if wall <= 0:
        return None
    inside = sum(t1 - t0 for _, t0, t1 in run.spans(set(ENGINE_ENTRIES)))
    return 100.0 * (1.0 - inside / wall)

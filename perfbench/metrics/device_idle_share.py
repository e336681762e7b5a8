"""The device's idle share of the traced sub-window: 1 - (the union of
its kernels' intervals) / (the sub-window), from one trace."""


def read(run):
    busy, span = run.busy_s(), run.sub_window_s()
    if busy is None or not span:
        return None
    return 100.0 * (1.0 - busy / span)

"""The control plane's ms a ``policy.schedule`` call (the harness's host
span around each call of the window, outside the profiled sub-window)."""


def read(run):
    spans = run.spans({"schedule"})
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1 in spans) / len(spans)

"""The control plane's ms a segment boundary on the continuous path: the
harness's host spans around the policy's ``validate`` and
``select_quant`` calls (admission control; the continuous runtime never
calls ``schedule``), over the window's data-plane calls, outside the
profiled sub-window."""


def read(run):
    calls = run.unprofiled
    if not calls:
        return None
    spans = run.spans({"validate", "select_quant"})
    return 1e3 * sum(t1 - t0 for _, t0, t1 in spans) / len(calls)

"""The program's own trace (``repro_torch.serving.trace``) as the
per-layer metrics read it.

The program's tracer keeps host spans, device intervals (CUDA events
placed on the host's ``perf_counter`` clock, the harness's clock), counts
and the card's gauges.  ``window(run)`` takes the records of the run's
window ``[rec.t_start, rec.t_end]`` less the profiled sub-window
(``rec.profile_span``, where the profiler slows the program), as the
host-clock metrics do.  It gives None where there is nothing to read: a
program without a tracer, or a tracer that dropped records inside the
window (with a line on standard error).  On the CPU the window holds no
device interval, and the metrics that read them give None.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from perfbench.harness.records import union_ns


class Window:
    """The window's pieces (host seconds, the profiled sub-window cut
    out) and the program's records inside them."""

    def __init__(self, run, trace):
        rec = run.rec
        t0, t1 = rec.t_start, rec.t_end
        ps = rec.profile_span
        if ps:
            p0, p1 = ps[0], t1 if ps[1] is None else ps[1]
            self.pieces = [(a, b) for a, b in ((t0, p0), (p1, t1)) if b > a]
        else:
            self.pieces = [(t0, t1)]
        self.run = run
        kept = trace.records()
        self.spans = [r for r in kept if isinstance(r, trace.Span)
                      and self.inside(r.t0, r.t1)]
        self.intervals = [r for r in kept if isinstance(r, trace.Interval)
                          and self.overlaps(r.t0, r.t1)]
        self.counts = [r for r in kept if isinstance(r, trace.Count)
                       and self.inside(r.t, r.t)]
        self.by_sid = {r.sid: r for r in self.spans}
        self.gauges = sorted((r for r in kept if isinstance(r, trace.Gauge)
                              and r.t <= t1), key=lambda g: g.t)

    def inside(self, a: float, b: float) -> bool:
        return any(p0 <= a and b <= p1 for p0, p1 in self.pieces)

    def overlaps(self, a: float, b: float) -> bool:
        return any(a < p1 and b > p0 for p0, p1 in self.pieces)

    def length_s(self) -> float:
        return sum(b - a for a, b in self.pieces)

    def clipped(self) -> List[Tuple[float, float]]:
        """The device intervals clipped to the pieces."""
        out = []
        for r in self.intervals:
            for p0, p1 in self.pieces:
                a, b = max(r.t0, p0), min(r.t1, p1)
                if b > a:
                    out.append((a, b))
        return out

    def busy_s(self) -> float:
        busy, _ = union_ns(self.clipped())
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches between the device intervals, piece by
        piece."""
        _, merged = union_ns(self.clipped())
        out = []
        for p0, p1 in self.pieces:
            inner = [m for m in merged if m[0] < p1 and m[1] > p0]
            edges = [p0] + [x for m in inner for x in m] + [p1]
            out += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                    if edges[i + 1] > edges[i]]
        return out

    def name_at(self, t: float) -> str:
        """The innermost program or harness span covering ``t``: a
        program span with its parents (``outer/inner``), a harness span
        as ``harness:<name>``."""
        best = None
        for r in self.spans:
            if r.t0 <= t <= r.t1 and (best is None or r.t1 - r.t0 <
                                      best[1] - best[0]):
                best = (r.t0, r.t1, r)
        for name, a, b, _ in self.run.rec.spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, "harness:" + name)
        if best is None:
            return "outside every span"
        if isinstance(best[2], str):
            return best[2]
        path, r = [best[2].name], best[2]
        while r.parent in self.by_sid:
            r = self.by_sid[r.parent]
            path.append(r.name)
        return "/".join(reversed(path))

    def calls(self) -> List[Dict]:
        """The harness's unprofiled data-plane calls, each with its host
        seconds, its device seconds by interval name and its loop
        iterations (the intervals and counts that lie inside the call)."""
        out = []
        for c in self.run.unprofiled:
            dev = {}
            for r in self.intervals:
                if c["t0"] <= r.t0 <= c["t1"]:
                    dev[r.name] = dev.get(r.name, 0.0) + r.t1 - r.t0
            iters = sum(r.value for r in self.counts if r.name == "iters"
                        and c["t0"] <= r.t <= c["t1"])
            out.append(dict(index=c["index"], t0=c["t0"], iters=iters,
                            host_s=c["t1"] - c["t0"], dev=dev))
        return out

    def gauge_at(self, t: float):
        """The last gauge read at or before ``t``, or None."""
        got = None
        for g in self.gauges:
            if g.t > t:
                break
            got = g
        return got


def window(run) -> Optional[Window]:
    try:
        from repro_torch.serving import trace
    except ImportError:
        return None
    if run.rec.t_start is None or run.rec.t_end is None:
        return None
    if trace.dropped_since(run.rec.t_start):
        print("the program's tracer dropped records inside the window: "
              "its metrics are not read", file=sys.stderr)
        return None
    return Window(run, trace)

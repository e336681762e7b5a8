"""What a run recorded, as the per-layer metrics read it.

``RunView`` holds the cell, the window's data-plane calls and spans, the
arena's counters and, in a traced run, the profiler's events of the
sub-window reduced to kernel intervals and the harness's annotations.
The profiled calls are kept apart: host-clock metrics of the traced run
are taken over the rest of its window, since the profiler slows the
host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def kineto_events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device kernels, harness annotations) of a finished profiler, each
    (name, start ns, end ns).  Reads the profiler's raw event list, which
    skips the slow linking of host and device events.  A range's mirror
    on the device carries the range's name and is no kernel."""
    from torch.autograd import DeviceType
    kernels, annots = [], []
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if name.startswith("pb."):
            if e.device_type() != DeviceType.CUDA:
                annots.append((name, a, b))
        elif e.device_type() == DeviceType.CUDA:
            kernels.append((name, a, b))
    return kernels, annots


def union_ns(intervals: List[tuple]) -> Tuple[int, List[tuple]]:
    """Busy nanoseconds of (start, end) intervals, and the merged ones."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [tuple(m) for m in merged]


class RunView:
    def __init__(self, cell: Dict, rec, engine_info: Dict,
                 arena: Optional[Dict]):
        self.cell = cell
        self.model = cell["config"]["model"]
        self.engine = cell["config"]["engine"]
        self.runtime = cell["traffic"]["runtime"]
        self.rec = rec
        self.engine_info = engine_info       # the decode tier, the captures
        self.arena = arena                   # alloc_peak, total_pages
        self.kernels: List[tuple] = []
        self.annots: List[tuple] = []
        self.sub_ns: Optional[Tuple[int, int]] = None
        if rec.profile is not None:
            self.kernels, self.annots = kineto_events(rec.profile)
            sub = [a for a in self.annots if a[0] == "pb.subwindow"]
            if sub:
                self.sub_ns = (sub[0][1], sub[0][2])
            if self.sub_ns is not None:
                a0, a1 = self.sub_ns
                self.kernels = [(n, max(a, a0), min(b, a1))
                                for n, a, b in self.kernels
                                if b > a0 and a < a1]

    # -- host side ------------------------------------------------------------

    @property
    def profiled(self) -> List[Dict]:
        return [c for c in self.rec.calls if c["profiled"]]

    @property
    def unprofiled(self) -> List[Dict]:
        return [c for c in self.rec.calls if not c["profiled"]]

    def profiled_span_s(self) -> float:
        ps = self.rec.profile_span
        return 0.0 if not ps or ps[1] is None else ps[1] - ps[0]

    def host_window_s(self) -> float:
        """The window's wall seconds less the profiled sub-window."""
        return (self.rec.t_end - self.rec.t_start) - self.profiled_span_s()

    def spans(self, names) -> List[tuple]:
        """Host spans of ``names`` in the window, outside the profiled
        sub-window."""
        ps = self.rec.profile_span
        out = []
        for name, t0, t1, _ in self.rec.spans:
            if name not in names:
                continue
            if ps and ps[1] is not None and t1 > ps[0] and t0 < ps[1]:
                continue
            out.append((name, t0, t1))
        return out

    # -- device side ----------------------------------------------------------

    def kernel_time_s(self, patterns) -> Tuple[float, Dict[str, int]]:
        """Summed device seconds of the sub-window's kernels whose names
        hold one of ``patterns``, and their event counts by pattern."""
        total, counts = 0, {p: 0 for p in patterns}
        for name, a, b in self.kernels:
            for p in patterns:
                if p in name:
                    total += b - a
                    counts[p] += 1
                    break
        return total * 1e-9, counts

    def busy_s(self) -> Optional[float]:
        if not self.kernels or self.sub_ns is None:
            return None
        busy, _ = union_ns([(a, b) for _, a, b in self.kernels])
        return busy * 1e-9

    def sub_window_s(self) -> Optional[float]:
        if self.sub_ns is None:
            return None
        return (self.sub_ns[1] - self.sub_ns[0]) * 1e-9

    def device_ops(self, top: int = 10) -> List[list]:
        by = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0) + (b - a)
        return [[name[:120], ns * 1e-9] for name, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps between the sub-window's kernels, each named
        by the innermost harness span the host was in at its middle."""
        if self.sub_ns is None or not self.kernels:
            return []
        _, merged = union_ns([(a, b) for _, a, b in self.kernels])
        edges = [self.sub_ns[0]] + [x for m in merged for x in m] \
            + [self.sub_ns[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        inner = [a for a in self.annots if a[0] != "pb.subwindow"]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) // 2
            cover = [x for x in inner if x[1] <= mid <= x[2]]
            name = min(cover, key=lambda x: x[2] - x[1])[0][3:] \
                if cover else "outside the harness's spans"
            out.append([name, (b - a) * 1e-9])
        return out

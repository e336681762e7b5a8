"""The serving engine's tracer: what the data plane did, kept in memory.

One tracer per process, on by default; ``enable(False)`` switches it
off.  It keeps the newest ``CAPACITY`` records in a ring and counts the
ones it dropped (``dropped_since``).  Four kinds of record, all on the
``time.perf_counter`` clock:

- :class:`Span`, a host span: name, start, end, the data-plane call it
  belongs to and its parent span.  A span opened while none is open is a
  root and draws a new call id; the spans inside it share that id.  One
  engine is single-threaded, so nesting is a stack.  While a torch
  profiler runs, each span is also a profiler range ``repro.<name>``, so
  the program's spans lie on the profiler's clock too; with no profiler,
  no range is made.  The range is a host-only one: a user range
  (``torch.profiler.record_function``) also leaves a mirror on the
  device's timeline, which a reader of the trace's device events would
  take for a kernel.
- :class:`Interval`, a device interval: two CUDA events recorded on the
  current stream around work that the host enqueues without waiting
  (``device``).  Its times are read only once a blocking device->host
  copy has completed both events (``read_back``), so the tracer adds no
  synchronisation.  Each read-back ends with an anchor, a host time and an
  event recorded together while the stream is idle; the next read-back
  places its intervals on the host clock from it (anchor host time plus
  the events' elapsed time from the anchor).  Intervals recorded before a
  device's first anchor are not placed.
- :class:`Count`, a number a call reports: ``iters``, the decode-loop
  iterations a read-back found; ``rows``, the rows a prefill admitted;
  ``nodes``, the kernel nodes of a step the engine captured;
  ``ssm_state_bytes``, on the hybrid family, the SSM and conv state bytes
  that captured step reads and writes.

The hybrid family's prefill in the published Zamba2 layout adds device
intervals ``dev.prefill.mamba`` (each Mamba2 mixer) and
``dev.prefill.shared`` (each shared-block site), nested in the engine's
``dev.prefill``.
- :class:`Gauge`: the card's SM clock (MHz), board power (W) and
  clock-event reason bitmask, read from NVML through ``ctypes`` at most
  once a second, after a read-back; none where NVML does not load.

``report()`` gives the operator's one-line summary of the records.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
import statistics
import time
from typing import NamedTuple, Optional

import torch

CAPACITY = 65536
GAUGE_PERIOD_S = 1.0
# a profiler range recorded on the host only (none where torch lacks it)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    call: int
    sid: int
    parent: Optional[int]


class Interval(NamedTuple):
    name: str
    t0: float
    t1: float
    call: Optional[int]


class Count(NamedTuple):
    name: str
    value: int
    t: float
    call: Optional[int]


class Gauge(NamedTuple):
    t: float
    sm_mhz: int
    power_w: float
    reasons: int


def _end(rec) -> float:
    return rec.t if isinstance(rec, (Count, Gauge)) else rec.t1


class Timing:
    """The host times of one open span (kept also with the tracer off)."""
    __slots__ = ("t0", "t1")

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class _Nvml:
    """The card's SM clock, power and clock-event reasons through NVML
    (``libnvidia-ml.so.1``, which ships with the card's kernel module),
    the CUDA device found by its PCI bus id.  Raises OSError where it
    cannot."""

    def __init__(self, device: torch.device):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        dev_t, uint_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(dev_t)]
        lib.nvmlDeviceGetClockInfo.restype = ctypes.c_int
        lib.nvmlDeviceGetClockInfo.argtypes = [dev_t, ctypes.c_int, uint_p]
        lib.nvmlDeviceGetPowerUsage.restype = ctypes.c_int
        lib.nvmlDeviceGetPowerUsage.argtypes = [dev_t, uint_p]
        reasons = getattr(lib, "nvmlDeviceGetCurrentClocksEventReasons",
                          None)
        reasons = reasons or lib.nvmlDeviceGetCurrentClocksThrottleReasons
        reasons.restype = ctypes.c_int
        reasons.argtypes = [dev_t, ctypes.POINTER(ctypes.c_ulonglong)]
        if lib.nvmlInit_v2():
            raise OSError("nvmlInit_v2 failed")
        p = torch.cuda.get_device_properties(device)
        bus = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:" \
              f"{p.pci_device_id:02x}.0"
        self.handle = dev_t()
        if lib.nvmlDeviceGetHandleByPciBusId_v2(bus.encode(),
                                                ctypes.byref(self.handle)):
            raise OSError(f"no NVML device at PCI bus id {bus}")
        self.lib, self._reasons = lib, reasons

    def read(self):
        """(SM MHz, board W, reason bitmask), or None where NVML fails."""
        mhz, mw = ctypes.c_uint(), ctypes.c_uint()
        bits = ctypes.c_ulonglong()
        if self.lib.nvmlDeviceGetClockInfo(self.handle, 1,  # NVML_CLOCK_SM
                                           ctypes.byref(mhz)) \
                or self.lib.nvmlDeviceGetPowerUsage(self.handle,
                                                    ctypes.byref(mw)) \
                or self._reasons(self.handle, ctypes.byref(bits)):
            return None
        return int(mhz.value), mw.value / 1e3, int(bits.value)


class _Tracer:
    def __init__(self, capacity: int = CAPACITY):
        self.on = True
        self.ring = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.dropped_until = -math.inf   # newest end among dropped records
        self.stack: list = []            # open spans: (sid, call)
        self.next_sid = self.next_call = 0
        self.pending: list = []          # (name, ev0, ev1, call, device)
        self.events: dict = {}           # device -> free timing events
        self.anchors: dict = {}          # device -> (host t, event)
        self.nvml: dict = {}             # device -> _Nvml or None
        self.gauge_t = -math.inf

    def add(self, rec) -> None:
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
            self.dropped_until = max(self.dropped_until, _end(self.ring[0]))
        self.ring.append(rec)

    def call(self) -> Optional[int]:
        return self.stack[-1][1] if self.stack else None

    @contextlib.contextmanager
    def span(self, name: str):
        timing = Timing()
        if not self.on:
            timing.t0 = time.perf_counter()
            try:
                yield timing
            finally:
                timing.t1 = time.perf_counter()
            return
        parent = self.stack[-1] if self.stack else None
        sid, call = self.next_sid, parent[1] if parent else self.next_call
        self.next_sid += 1
        self.next_call += parent is None
        self.stack.append((sid, call))
        rng = None
        if _RANGE is not None \
                and torch.autograd.profiler._is_profiler_enabled:
            rng = _RANGE("repro." + name)
            rng.__enter__()
        timing.t0 = time.perf_counter()
        try:
            yield timing
        finally:
            timing.t1 = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            self.stack.pop()
            self.add(Span(name, timing.t0, timing.t1, call, sid,
                          parent[0] if parent else None))

    def event(self, dev: int):
        free = self.events.setdefault(dev, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def device(self, name: str, device: torch.device):
        if not self.on or device.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(device)
        dev = stream.device_index
        ev0 = self.event(dev)
        ev0.record(stream)
        yield
        ev1 = self.event(dev)
        ev1.record(stream)
        self.pending.append((name, ev0, ev1, self.call(), dev))

    @contextlib.contextmanager
    def read_back(self, device: torch.device):
        if not self.on or device.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(device)
        dev = stream.device_index
        ev0 = self.event(dev)
        ev0.record(stream)
        yield                      # ends in a blocking device->host copy
        anchor = self.event(dev)
        now = time.perf_counter()
        anchor.record(stream)
        self.pending.append(("dev.read_back", ev0, None, self.call(), dev))
        self._place(dev, now)
        self.anchors[dev] = (now, anchor)
        self._gauge(device, now)

    def _place(self, dev: int, now: float) -> None:
        """Place the device's completed intervals on the host clock from
        its last anchor; a read-back's interval ends at ``now``."""
        old = self.anchors.get(dev)
        keep = []
        for rec in self.pending:
            name, ev0, ev1, call, d = rec
            if d != dev or (ev1 is not None and not ev1.query()):
                keep.append(rec)
                continue
            if old is not None:
                t0 = old[0] + old[1].elapsed_time(ev0) * 1e-3
                t1 = now if ev1 is None else \
                    old[0] + old[1].elapsed_time(ev1) * 1e-3
                self.add(Interval(name, t0, t1, call))
            self.events[dev].append(ev0)
            if ev1 is not None:
                self.events[dev].append(ev1)
        self.pending = keep
        if old is not None:
            self.events[dev].append(old[1])

    def _gauge(self, device: torch.device, now: float) -> None:
        if now - self.gauge_t < GAUGE_PERIOD_S:
            return
        self.gauge_t = now
        if device not in self.nvml:
            try:
                self.nvml[device] = _Nvml(device)
            except (OSError, AttributeError):
                self.nvml[device] = None
        nvml = self.nvml[device]
        got = nvml.read() if nvml is not None else None
        if got is not None:
            self.add(Gauge(now, *got))


_T = _Tracer()


def enable(flag: bool) -> None:
    """Switch the tracer on or off (on at import)."""
    _T.on = bool(flag)


def reset(capacity: int = CAPACITY) -> None:
    """Forget every record and start a ring of ``capacity``."""
    on = _T.on
    _T.__init__(capacity)
    _T.on = on


def span(name: str):
    """A host span (context manager) that yields its :class:`Timing`."""
    return _T.span(name)


def traced(name: str):
    """Decorator: the function's calls are spans ``name`` (roots of the
    data-plane calls)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _T.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def device(name: str, device: torch.device):
    """A device interval around work enqueued on ``device``'s current
    stream without a host wait (context manager; nothing off CUDA)."""
    return _T.device(name, device)


def read_back(device: torch.device):
    """Context manager around a blocking device->host copy on ``device``'s
    current stream: its interval ``dev.read_back``, then the placing of
    the device's completed intervals, a new anchor and, at most once a
    second, a gauge."""
    return _T.read_back(device)


def count(name: str, value: int) -> None:
    """A count of the running call."""
    if _T.on:
        _T.add(Count(name, int(value), time.perf_counter(), _T.call()))


def records() -> list:
    """The records kept, oldest first by when they were added."""
    return list(_T.ring)


def dropped_since(t: float) -> bool:
    """Whether the ring dropped a record that ended at or after ``t``."""
    return _T.dropped_until >= t


def _union_s(intervals) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def report(since: float = -math.inf) -> str:
    """The operator's line: prefill ms, decode-step ms, the card's idle
    share over the data-plane calls' span, the captures with their ms and
    kernel nodes, and the last SM clock and power, from the records kept
    that end at or after ``since`` (a ``time.perf_counter`` time)."""
    recs = [r for r in records() if _end(r) >= since]
    spans = [r for r in recs if isinstance(r, Span)]
    ivs = [r for r in recs if isinstance(r, Interval)]
    if not ivs:
        return "[trace] no device intervals (tracer off, or no CUDA device)"
    # calls whose intervals were placed (a device's first read-back has no
    # anchor), and those whose read-back placed the loop's intervals too
    calls = {r.call for r in ivs}
    placed = {r.call for r in ivs if r.name == "dev.read_back"}
    pre = [1e3 * (r.t1 - r.t0) for r in ivs if r.name == "dev.prefill"]
    dec = sum(r.t1 - r.t0 for r in ivs if r.name == "dev.decode")
    iters = sum(r.value for r in recs if isinstance(r, Count)
                and r.name == "iters" and r.call in placed)
    rows = sum(r.value for r in recs if isinstance(r, Count)
               and r.name == "rows" and r.call in calls)
    bounds = [r for r in spans if r.parent is None and r.call in calls] \
        or ivs
    t0, t1 = min(r.t0 for r in bounds), max(r.t1 for r in bounds)
    caps = [1e3 * (r.t1 - r.t0) for r in spans if r.name == "engine.capture"]
    nodes = [r.value for r in recs if isinstance(r, Count)
             and r.name == "nodes"]
    gauges = [r for r in recs if isinstance(r, Gauge)]
    out = [f"prefill {statistics.median(pre):.2f} ms (median of "
           f"{len(pre)}, {rows} rows)" if pre else "no prefill"]
    out.append(f"decode step {1e3 * dec / iters:.3f} ms ({iters} "
               f"iterations)" if iters else "no decode iterations")
    idle = 1.0 - _union_s((r.t0, r.t1) for r in ivs) / (t1 - t0)
    out.append(f"card idle {100 * idle:.2f} % of {t1 - t0:.3f} s")
    out.append(f"captures {len(caps)}, ms {[round(c, 1) for c in caps[:8]]}"
               + (" ..." if len(caps) > 8 else "")
               + (f", kernel nodes {nodes[:8]}" if nodes else ""))
    if gauges:
        g = gauges[-1]
        out.append(f"SM {g.sm_mhz} MHz, {g.power_w:.1f} W")
    if _T.dropped:
        out.append(f"({_T.dropped} records dropped)")
    return "[trace] " + "; ".join(out)

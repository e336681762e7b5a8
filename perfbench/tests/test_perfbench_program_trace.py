"""The readers of the program's own trace (``decode_step_ms``,
``prefill_ms``, ``capture_ms``, ``card_idle_share``) on records made by
hand: their values over a window with a profiled sub-window cut out,
None where the window holds no device interval (a CPU run), and None
where the tracer dropped records inside the window."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import bench  # noqa: E402
from repro_torch.serving import trace  # noqa: E402

NAMES = ("decode_step_ms", "prefill_ms", "capture_ms", "card_idle_share")


class _Rec:
    """The harness's recorder as the readers see it: the window, the
    profiled sub-window, the data-plane calls and the harness's spans."""

    def __init__(self):
        self.t_start, self.t_end = 10.0, 20.0
        self.profile_span = [14.0, 16.0]
        self.calls = [dict(index=0, t0=10.0, t1=12.0, profiled=False),
                      dict(index=1, t0=14.0, t1=16.0, profiled=True),
                      dict(index=2, t0=17.0, t1=19.6, profiled=False)]
        self.spans = [("execute", 10.0, 12.0, 0), ("execute", 17.0, 19.6, 2),
                      ("schedule", 12.5, 13.5, None)]


class _Run:
    def __init__(self):
        self.rec = _Rec()

    @property
    def unprofiled(self):
        return [c for c in self.rec.calls if not c["profiled"]]


def _span(name, t0, t1, call, sid, parent=None):
    trace._T.add(trace.Span(name, t0, t1, call, sid, parent))


def _records(device=True):
    """Three calls: 0 and 2 in the window, 1 in the profiled sub-window;
    one interval starts before the window."""
    add = trace._T.add
    _span("engine.generate", 10.2, 11.45, 0, 0)
    _span("engine.generate", 14.05, 15.7, 1, 1)
    _span("engine.capture", 14.55, 14.58, 1, 2, 1)
    _span("engine.generate_chunked", 17.4, 17.5, 2, 3)
    _span("engine.capture", 17.42, 17.46, 2, 4, 3)
    _span("engine.capture", 5.0, 5.1, None, 5)
    if device:
        for name, a, b, call in (
                ("dev.decode", 9.5, 10.05, None),
                ("dev.prefill", 10.1, 10.3, 0), ("dev.decode", 10.4, 11.4, 0),
                ("dev.read_back", 11.4, 11.41, 0),
                ("dev.prefill", 14.1, 14.5, 1), ("dev.decode", 14.6, 15.6, 1),
                ("dev.prefill", 17.1, 17.4, 2), ("dev.decode", 17.5, 19.5, 2),
                ("dev.read_back", 19.5, 19.51, 2)):
            add(trace.Interval(name, a, b, call))
    for name, value, t, call in (
            ("rows", 8, 10.05, 0), ("iters", 100, 11.41, 0),
            ("iters", 50, 15.6, 1), ("iters", 100, 19.51, 2)):
        add(trace.Count(name, value, t, call))
    add(trace.Gauge(10.0, 1980, 312.5, 0))
    add(trace.Gauge(18.0, 1755, 650.0, 4))


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def _read(name):
    return bench.metric_reader(name)(_Run())


def test_values_over_the_window_less_the_sub_window(capsys):
    _records()
    # calls 0 and 2: 1.0 s + 2.0 s of loop over 200 iterations
    assert _read("decode_step_ms") == pytest.approx(15.0)
    assert _read("prefill_ms") == pytest.approx(250.0)
    assert _read("capture_ms") == pytest.approx(40.0)
    busy = 0.05 + 0.2 + 1.0 + 0.01 + 0.3 + 2.0 + 0.01
    assert _read("card_idle_share") == pytest.approx(100 * (1 - busy / 8.0))
    err = capsys.readouterr().err
    assert "call 0 age" in err and "call 2 age" in err and "call 1 " not in err
    assert "10.0000 ms x 100; host 2000.000 ms, device ms decode 1000.000 " \
        "prefill 200.000 read_back 10.000; 1980 MHz 312.5 W reasons 0x0" in err
    assert "20.0000 ms x 100; host 2600.000 ms" in err
    assert "; 1980 MHz" in err.split("call 2 age")[1]  # the gauge before it
    # the gap inside the capture is named by the span and its parent
    assert "engine.generate_chunked/engine.capture 100.00 ms" in err
    assert "engine.generate 100.00 ms" in err
    assert "harness:schedule" in err and "harness:execute" in err
    assert "outside every span" in err


def test_none_without_device_intervals():
    _records(device=False)
    for name in ("decode_step_ms", "prefill_ms", "card_idle_share"):
        assert _read(name) is None
    trace.reset()
    _span("engine.generate", 10.05, 11.45, 0, 0)
    assert _read("capture_ms") is None


def test_none_when_records_were_dropped_inside_the_window(capsys):
    trace.reset(capacity=8)
    _records()
    for name in NAMES:
        assert _read(name) is None
    assert "dropped" in capsys.readouterr().err


def test_drops_before_the_window_leave_it_read():
    trace.reset(capacity=24)
    for i in range(30):
        trace._T.add(trace.Count("rows", 1, 1.0 + i / 100, None))
    _records()
    assert trace._T.dropped > 0
    assert _read("prefill_ms") == pytest.approx(250.0)

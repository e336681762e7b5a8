"""The serving engine's tracer (``repro_torch.serving.trace``) on the CPU:
span nesting and call ids, the ring's bound and its count of dropped
records, the switch, profiler ranges only under a running profiler, and
the engine's root spans with their counts.  Device intervals and the
card's gauges need a card (``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_loop import DeviceLoop
from repro_torch.serving import trace
from repro_torch.serving.engine import tiny_engine


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(True)
    trace.reset()


def _spans():
    return [r for r in trace.records() if isinstance(r, trace.Span)]


def test_spans_nest_with_parent_links_and_call_ids():
    with trace.span("a"):
        with trace.span("b"):
            with trace.span("c"):
                trace.count("n", 3)
        with trace.span("d"):
            pass
    with trace.span("e"):
        pass
    by = {s.name: s for s in _spans()}
    assert by["a"].parent is None and by["e"].parent is None
    assert by["b"].parent == by["a"].sid == by["d"].parent
    assert by["c"].parent == by["b"].sid
    assert by["a"].call == by["b"].call == by["c"].call == by["d"].call
    assert by["e"].call != by["a"].call
    assert by["a"].t0 <= by["b"].t0 <= by["c"].t0 <= by["c"].t1 \
        <= by["b"].t1 <= by["d"].t0 <= by["a"].t1 <= by["e"].t0
    (n,) = [r for r in trace.records() if isinstance(r, trace.Count)]
    assert (n.name, n.value, n.call) == ("n", 3, by["a"].call)
    trace.count("outside", 1)
    assert trace.records()[-1].call is None


def test_a_span_that_raises_is_kept_and_closed():
    with pytest.raises(ValueError):
        with trace.span("a"):
            raise ValueError
    with trace.span("b"):
        pass
    a, b = _spans()
    assert a.parent is None and b.parent is None and a.call != b.call


def test_ring_keeps_the_newest_and_counts_the_dropped():
    trace.reset(capacity=4)
    for i in range(7):
        trace.count("i", i)
    got = trace.records()
    assert [r.value for r in got] == [3, 4, 5, 6]
    assert trace._T.dropped == 3
    assert trace.dropped_since(got[0].t - 1.0)
    assert not trace.dropped_since(got[0].t)
    trace.reset(capacity=4)
    assert not trace.records() and not trace.dropped_since(-1e300)


def test_off_records_nothing_but_still_times():
    trace.enable(False)
    with trace.span("a") as timing:
        with trace.span("b"):
            trace.count("n", 1)
    assert not trace.records()
    assert timing.ms >= 0.0 and timing.t1 >= timing.t0
    trace.enable(True)
    with trace.span("c"):
        pass
    assert [s.name for s in _spans()] == ["c"]


def test_profiler_range_only_under_a_running_profiler(monkeypatch):
    made = []
    real = trace._RANGE
    assert real is not None

    def counting(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(trace, "_RANGE", counting)
    with trace.span("quiet"):
        pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).add_(1)
    assert made == ["repro.outer", "repro.inner"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert {"repro.outer", "repro.inner"} <= set(events)
    # a host range, not a user range: no mirror on a device's timeline
    assert not events["repro.outer"].is_user_annotation()
    with trace.span("quiet_again"):
        pass
    assert len(made) == 2


def test_no_device_interval_off_cuda():
    dev = torch.device("cpu")
    with trace.device("dev.x", dev):
        torch.ones(2)
    with trace.read_back(dev):
        torch.ones(2).numpy()
    assert not trace.records() and not trace._T.pending


class _StandInLoop(DeviceLoop):
    """A device loop without a device: its iteration count is set by hand
    (this CPU has no graph to launch)."""

    def __init__(self):                    # noqa: D107 (no CUDA build)
        self.launches = {}
        self.iters = torch.zeros((), dtype=torch.int64)
        self.counted = 0


def _by_call():
    calls = {}
    for r in trace.records():
        calls.setdefault(r.call, []).append(r)
    return calls


def test_engine_entries_are_root_spans_with_their_counts():
    torch.manual_seed(0)
    eng = tiny_engine("bloom-3b", batch_capacity=4, s_max=16, n_max=8,
                      device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 9, 3)]
    eng.generate(prompts[:2], [8, 8])
    eng._gen.graphs[eng._gen.bits] = gen_loop = _StandInLoop()
    gen_loop.iters.fill_(6)
    trace.reset()
    eng.generate(prompts, [8, 4, 8])
    st = eng.start_chunked(prompts[:2], [8, 8])
    st.graphs[st.bits] = loop = _StandInLoop()
    st = eng.generate_chunked(st, 4)
    loop.iters.fill_(4)
    eng.poll_chunked(st)
    st = eng.refill_chunked(st, [2, 3], prompts[1:], [3, 3], t_now=4)
    st = eng.generate_chunked(st, 4)
    loop.iters.fill_(7)
    eng.poll_chunked(st, with_tokens=False)
    del eng._gen.graphs[eng._gen.bits]

    roots = [s for s in _spans() if s.parent is None]
    assert [s.name for s in roots] == [
        "engine.generate", "engine.start_chunked", "engine.generate_chunked",
        "engine.poll_chunked", "engine.refill_chunked",
        "engine.generate_chunked", "engine.poll_chunked"]
    assert len({s.call for s in roots}) == len(roots)
    assert all(s.parent is None for s in _spans())   # no capture on the CPU
    calls = _by_call()
    want = [[("rows", 3), ("iters", 6)], [("rows", 2)], [], [("iters", 4)],
            [("rows", 2)], [], [("iters", 3)]]
    for root, counts in zip(roots, want):
        got = [(r.name, r.value) for r in calls[root.call]
               if isinstance(r, trace.Count)]
        assert got == counts, root.name
        assert all(root.t0 <= r.t <= root.t1 for r in calls[root.call]
                   if isinstance(r, trace.Count))
    assert not [r for r in trace.records()
                if isinstance(r, (trace.Interval, trace.Gauge))]
    assert "no device intervals" in trace.report()


def test_a_refill_with_no_headroom_counts_no_rows():
    eng = tiny_engine("bloom-3b", batch_capacity=4, s_max=16, n_max=8,
                      device="cpu")
    st = eng.start_chunked([[1, 2, 3]], [8])
    trace.reset()
    assert eng.refill_chunked(st, [1], [[4, 5]], [3], t_now=8) is st
    (root,) = _spans()
    assert root.name == "engine.refill_chunked"
    assert not [r for r in trace.records() if isinstance(r, trace.Count)]


def test_report_reads_only_the_calls_whose_intervals_were_placed():
    """The operator's line over hand-made records: a first call whose
    intervals had no anchor to be placed by (its rows and iterations are
    left out with them), then two calls of 100 iterations each."""
    add = trace._T.add
    add(trace.Count("rows", 8, 0.1, 0))
    add(trace.Count("iters", 128, 0.9, 0))
    add(trace.Span("engine.generate", 0.0, 1.0, 0, 0, None))
    for call, t in ((1, 2.0), (2, 3.0)):
        add(trace.Count("rows", 8, t, call))
        add(trace.Interval("dev.prefill", t, t + 0.2, call))
        add(trace.Interval("dev.decode", t + 0.2, t + 0.9, call))
        add(trace.Interval("dev.read_back", t + 0.9, t + 0.91, call))
        add(trace.Count("iters", 100, t + 0.91, call))
        add(trace.Span("engine.generate", t, t + 0.95, call, call, None))
    add(trace.Span("engine.capture", 2.05, 2.1, 1, 9, 1))
    add(trace.Gauge(2.5, 1980, 301.0, 0))
    line = trace.report()
    assert line.startswith("[trace] prefill 200.00 ms (median of 2, 16 rows)")
    assert "decode step 7.000 ms (200 iterations)" in line
    assert "card idle 6.67 % of 1.950 s" in line      # 1 - 1.82 / 1.95
    assert "captures 1, ms [50.0]" in line and "SM 1980 MHz, 301.0 W" in line
    later = trace.report(since=2.97)                 # the last call only
    assert "(median of 1, 8 rows)" in later and "(100 iterations)" in later

"""The harness's own spans around the serving program's public entries.

Nothing here changes what the program does: the policy is wrapped by a
delegating ``SchedulerPolicy``, and the engine and the executors are
subclasses whose overrides time the call, note what it returned and call
the program's own method.  Records go to a :class:`Recorder`, which also
closes the measured window (:class:`WindowClosed`, raised out of the
runtime's loop after the data-plane call that crossed the window's end)
and drives the profiler over the traced run's sub-window.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.policy import SchedulerPolicy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runtime import (EngineContinuousExecutor,
                                         EngineExecutor)

ENGINE_ENTRIES = ("generate", "start_chunked", "refill_chunked",
                  "generate_chunked", "poll_chunked")


class WindowClosed(Exception):
    """Raised after the data-plane call that ended past the window."""


class Recorder:
    """Spans, per-call records and the rows served, for one run."""

    def __init__(self, seconds: float, flops=None, profile_calls=(0, 0),
                 profiler_factory=None):
        self.seconds = float(seconds)
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.spans: List[tuple] = []       # (name, t0, t1, call index)
        self.calls: List[Dict] = []        # one per data-plane call
        self.rows: List[Dict] = []         # served rows, for the check
        self.latency_s: List[float] = []   # one per served request
        self.flops = flops                 # (s, j0, j1) -> model FLOPs
        self.p0, self.pn = profile_calls   # first profiled call, count
        self.profiler_factory = profiler_factory
        self.profiler = None
        self.profile = None                # the finished profiler
        self.profile_span = None           # host clock, the profiler's
                                           # start and stop included
        self._call: Optional[Dict] = None
        self._annot = None
        self.last_admit: Optional[Dict] = None   # the last prefill's rows

    # -- the window ----------------------------------------------------------

    def open(self) -> None:
        self.t_start = time.perf_counter()

    @property
    def open_window(self) -> bool:
        return self.t_start is not None and self.t_end is None

    def begin_call(self, kind: str) -> Dict:
        """A data-plane call starts; profiles it if it is in the traced
        sub-window."""
        idx = len(self.calls)
        if self.profiler_factory is not None and idx == self.p0 \
                and self.pn > 0:
            self.profile_span = [time.perf_counter(), None]
            torch.cuda.synchronize()
            self.profiler = self.profiler_factory()
            self.profiler.__enter__()
            self._annot = torch.profiler.record_function("pb.subwindow")
            self._annot.__enter__()
        call = dict(kind=kind, index=idx, t0=time.perf_counter(), t1=None,
                    tokens=0, flops=0, steps=[], prefills=0, captures=0,
                    profiled=self.profiler is not None)
        self._call = call
        return call

    def end_call(self, call: Dict) -> None:
        call["t1"] = time.perf_counter()
        self.calls.append(call)
        self._call = None
        if self.profiler is not None and call["index"] == self.p0 + \
                self.pn - 1:
            self._annot.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.profiler.__exit__(None, None, None)
            self.profile_span[1] = time.perf_counter()
            self.profile, self.profiler, self._annot = self.profiler, None, \
                None
        if call["t1"] - self.t_start >= self.seconds:
            self.t_end = call["t1"]
            raise WindowClosed()

    def finish(self) -> None:
        """Close a profiler that the window's end left open (the
        sub-window was cut short: no trace is read from it)."""
        if self.profiler is not None:
            self._annot.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
            self.profiler = self._annot = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span; inside the profiled sub-window also a
        profiler annotation, so that the trace's idle gaps can be named."""
        annot = None
        if self.profiler is not None:
            annot = torch.profiler.record_function("pb." + name)
            annot.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if annot is not None:
                annot.__exit__(None, None, None)
            if self.open_window:
                idx = self._call["index"] if self._call else None
                self.spans.append((name, t0, t1, idx))

    def note(self, **kw) -> None:
        """Add to the running data-plane call's counts."""
        if self._call is None:
            return
        for k, v in kw.items():
            if isinstance(self._call.get(k), list):
                self._call[k].append(v)
            else:
                self._call[k] = self._call.get(k, 0) + v


class TimedPolicy(SchedulerPolicy):
    """Delegates to the cell's policy; times each call.  What else the
    runtime reads or installs on its policy (``split``, ``calib``, the
    measured coefficients and swap costs) is the cell's policy's."""

    def __init__(self, inner: SchedulerPolicy, rec: Recorder):
        self.inner = inner
        self.rec = rec
        self.name = inner.name

    def __getattr__(self, name):
        if name == "inner":             # not yet set
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def spec(self) -> str:
        return self.inner.spec

    def schedule(self, env, queue):
        with self.rec.span("schedule"):
            return self.inner.schedule(env, queue)

    def validate(self, env, decision):
        with self.rec.span("validate"):
            return self.inner.validate(env, decision)

    def select_quant(self, env, model_id, batch):
        with self.rec.span("select_quant"):
            return self.inner.select_quant(env, model_id, batch)


def _loop_iters(state, seen: Dict[int, int]) -> Optional[int]:
    """Device-loop iterations of ``state``'s loops since last seen (the
    program's own count, read back by its last device->host copy); None
    where the state has no device loop (the CPU's eager loop)."""
    loops = list((state.graphs or {}).values())
    if not loops:
        return None
    n = 0
    for loop in loops:
        n += loop.counted - seen.get(id(loop), 0)
        seen[id(loop)] = loop.counted
    return n


class TimedEngine(ServingEngine):
    """``ServingEngine`` with the harness's spans on its public entries."""

    rec: Recorder = None

    def _bind(self, rec: Recorder) -> None:
        self.rec = rec
        self._seen: Dict[int, int] = {}
        self._cohorts: Dict[int, Dict] = {}   # id(lengths) -> host view

    def generate(self, prompts, n_tokens=None, greedy=True,
                 quant_bits=None):
        rec = self.rec
        with rec.span("generate"):
            res = super().generate(prompts, n_tokens, greedy, quant_bits)
        iters = _loop_iters(self._gen, self._seen)
        steps = int(iters) if iters is not None else \
            min(self.n_max, int(max(n_tokens or [self.n_max])))
        rec.note(steps=(0, steps), prefills=1,
                 tokens=int(res.lengths.sum()))
        fl = 0
        bits = self._gen.bits                # as the engine resolved it
        for i, p in enumerate(prompts):
            n = int(res.lengths[i])
            s = min(len(p), self.s_max)
            fl += rec.flops(s, None, None) + rec.flops(s, 0, n)
            if rec.open_window:
                rec.rows.append(dict(prompt=list(p), gap=0,
                                     tokens=res.tokens[i, :n].copy(),
                                     slot=i, bits=bits))
        rec.note(flops=fl)
        return res

    def _admit_rows(self, state, slots, prompts, gap):
        view = self._cohorts.setdefault(
            id(state.lengths), dict(prev=np.zeros(self.batch_capacity,
                                                  np.int64),
                                    s=np.zeros(self.batch_capacity,
                                               np.int64)))
        fl = 0
        for slot, p in zip(slots, prompts):
            s = min(len(p), self.s_max)
            view["prev"][slot] = 0
            view["s"][slot] = s
            fl += self.rec.flops(s, None, None)
        self.rec.note(prefills=1, flops=fl)
        self.rec.last_admit = dict(slots=list(slots), prompts=list(prompts),
                                   gap=gap, bits=state.bits)

    def start_chunked(self, prompts, n_tokens=None, quant_bits=None,
                      arena=None, prefixes=None):
        with self.rec.span("start_chunked"):
            st = super().start_chunked(prompts, n_tokens, quant_bits, arena,
                                       prefixes)
        self._admit_rows(st, range(len(prompts)), prompts, 0)
        self._cohorts[id(st.lengths)]["t"] = 0
        return st

    def refill_chunked(self, state, slots, prompts, n_tokens, t_now,
                       cap_max=None, prefixes=None):
        with self.rec.span("refill_chunked"):
            st = super().refill_chunked(state, slots, prompts, n_tokens,
                                        t_now, cap_max, prefixes)
        if st is not state:
            self._admit_rows(st, slots, prompts, int(t_now))
        return st

    def generate_chunked(self, state, k):
        n = len(self.captures)
        with self.rec.span("generate_chunked"):
            st = super().generate_chunked(state, k)
        self.rec.note(captures=len(self.captures) - n)
        return st

    def poll_chunked(self, state, with_tokens=True):
        with self.rec.span("poll_chunked"):
            out = super().poll_chunked(state, with_tokens)
        _, lengths, _, t = out
        view = self._cohorts.get(id(state.lengths))
        if view is not None:
            iters = _loop_iters(state, self._seen)
            t0 = view.get("t", 0)
            steps = int(iters) if iters is not None else t - t0
            if steps:
                self.rec.note(steps=(t0, steps))
            view["t"] = t
            new = np.maximum(lengths.astype(np.int64) - view["prev"], 0)
            fl = sum(self.rec.flops(int(view["s"][b]), int(view["prev"][b]),
                                    int(lengths[b]))
                     for b in np.nonzero(new)[0])
            self.rec.note(tokens=int(new.sum()), flops=fl)
            view["prev"] = np.maximum(view["prev"], lengths)
        return out


class TimedEpochExecutor(EngineExecutor):
    """``EngineExecutor`` whose ``execute`` is one data-plane call of the
    window: every request of the batch waits for the whole call."""

    rec: Recorder = None

    def execute(self, env, decision):
        rec = self.rec
        reqs = decision.selected
        if not reqs or not rec.open_window:
            return super().execute(env, decision)
        call = rec.begin_call("execute")
        with rec.span("execute"):
            tokens = super().execute(env, decision)
        call["requests"] = len(reqs)
        rec.latency_s.extend([time.perf_counter() - call["t0"]] * len(reqs))
        rec.end_call(call)
        return tokens


class TimedContinuousExecutor(EngineContinuousExecutor):
    """``EngineContinuousExecutor`` whose ``step`` (one segment, with the
    admissions placed at its boundary) is one data-plane call of the
    window.  A request's latency runs from the start of the step that
    admitted it to the end of the step it finished in."""

    rec: Recorder = None

    def _bind(self, rec: Recorder) -> None:
        self.rec = rec
        self.admitted_at: Dict[int, float] = {}
        self.meta: Dict[int, Dict] = {}

    def step(self, env, k):
        rec = self.rec
        if not rec.open_window:
            return super().step(env, k)
        pending = [(slot, r, resume) for pool in self._pools.values()
                   for slot, r, resume, _ in pool["pending"]]
        if not pending and self.idle():
            return super().step(env, k)
        call = rec.begin_call("step")
        rec.last_admit = None
        with rec.span("step"):
            finished, occ = super().step(env, k)
        adm = rec.last_admit
        for i, (slot, r, resume) in enumerate(pending):
            self.admitted_at[r.rid] = call["t0"]
            if adm is not None and len(adm["prompts"]) == len(pending) \
                    and resume is None:
                self.meta[r.rid] = dict(prompt=adm["prompts"][i],
                                        gap=adm["gap"], slot=slot,
                                        bits=adm["bits"])
        t1 = time.perf_counter()
        for _, r, _ in finished:
            t0 = self.admitted_at.pop(r.rid, None)
            if t0 is not None:
                rec.latency_s.append(t1 - t0)
            meta = self.meta.pop(r.rid, None)
            if meta is not None and r.rid in self.outputs:
                rec.rows.append(dict(
                    prompt=list(meta["prompt"]), gap=meta["gap"],
                    tokens=self.outputs.pop(r.rid), slot=meta["slot"],
                    bits=meta["bits"]))
        call["requests"] = len(finished)
        rec.end_call(call)
        return finished, occ

"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the check against the reference, and the result line."""
from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.harness import bench, check
from perfbench.harness.drive import (Recorder, TimedContinuousExecutor,
                                     TimedEngine, TimedEpochExecutor,
                                     TimedPolicy, WindowClosed)
from perfbench.harness.records import RunView
from perfbench.harness.traffic import PoissonTraffic

EPOCHS = 1_000_000            # more than any window holds; the window ends
                              # the run


def port_config(arch_mod, model: Dict, arch: str, reduced: bool):
    """The program's configuration of ``arch``; it has to hold the sizes
    of the file's "model" block, as the architecture's module
    ``arch_mod`` compares them (a reduced one for the CPU tests is cut to
    them)."""
    from repro_torch.config import get_arch
    cfg = get_arch(arch)
    if reduced:
        cfg = arch_mod.scaled_program(cfg, model)
    have, want = arch_mod.program_sizes(cfg), arch_mod.file_sizes(model)
    if have != want:
        raise ValueError(f"the program's {arch} is not the configuration "
                         f"file's: {have} != {want}")
    return cfg


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def _warm_rows(engine, n_rows: int, seed: int):
    rng = np.random.default_rng(int(seed) + 1)
    prompts = [rng.integers(1, engine.cfg.vocab, size=engine.s_max).tolist()
               for _ in range(n_rows)]
    return prompts, [engine.n_max] * n_rows


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             override: Optional[Dict] = None,
             keep: Optional[Dict] = None) -> Dict:
    """Run cell ``name``; returns the result line's object.  ``override``
    (CPU tests only) replaces parts of the cell's files; ``keep``, where
    given, receives the architecture's module, the weights, the checked
    sample and its gaps (for the control's readings,
    ``perfbench/control.py``)."""
    cell = bench.load_cell(name, override)
    conf, mix = cell["config"], cell["traffic"]
    arch_mod = cell["arch_module"]
    model, eng_kw = conf["model"], conf["engine"]
    on_cuda = device == "cuda"
    dev = torch.device(device)
    cfg = port_config(arch_mod, model, conf["arch"], reduced=bool(override))

    from repro_torch.core.environment import h100_env
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_arena import KVArena
    from repro_torch.serving.runtime import ContinuousRuntime, EpochRuntime

    def flops(s, j0, j1):
        if j0 is None:
            return arch_mod.prompt_flops(model, s)
        return arch_mod.tokens_flops(model, s, j0, j1)

    rt = mix["runtime"]
    profile_calls = (0, 0)
    factory = None
    if trace and on_cuda:
        from torch.profiler import ProfilerActivity, profile
        profile_calls = tuple(mix["profile_calls"])

        def factory():
            return profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        # the profiler's first start comes before the engine captures its
        # loop: the trace holds a captured graph's kernels only where the
        # profiler was started before the graph was built
        with factory():
            torch.ones(1, device=device).add_(1)
    rec = Recorder(seconds, flops=flops, profile_calls=profile_calls,
                   profiler_factory=factory)

    # -- set-up: weights from the seed, the engine, the control plane --------
    marks = [("start", time.perf_counter())]
    params = arch_mod.make_params(model, seed, dev)
    if on_cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    engine = TimedEngine(cfg, params=params,
                         batch_capacity=eng_kw["batch_capacity"],
                         s_max=eng_kw["s_max"], n_max=eng_kw["n_max"],
                         quant_bits=eng_kw["quant_bits"],
                         eos_id=eng_kw["eos_id"], seed=0, device=dev)
    engine._bind(rec)
    marks.append(("engine", time.perf_counter()))
    env = h100_env(conf["arch"], conf["env"]["method"]).with_(model=cfg)
    policy = TimedPolicy(get_policy(mix["policy"]), rec)
    traffic = PoissonTraffic(mix["arrivals"], seed)
    arena = warmed = None
    if rt["kind"] == "epoch":
        executor = TimedEpochExecutor(engine, seed=seed)
        executor.rec = rec
        prompts, caps = _warm_rows(engine, engine.batch_capacity, seed)
        engine.generate(prompts, caps)              # prefill, capture, loop
        runtime = EpochRuntime(env, policy, executor)
    elif rt["kind"] == "continuous":
        ar = rt["arena"]
        warm = KVArena.for_engines(engine, block_tokens=ar["block_tokens"],
                                   shrink=ar["shrink"])
        per_row = engine.pages_for_admission(0, engine.n_max,
                                             ar["block_tokens"])
        n = max(1, min(engine.batch_capacity, warm.total_pages // per_row))
        prompts, caps = _warm_rows(engine, n, seed)
        st = engine.start_chunked(prompts, caps, arena=warm)
        st = engine.generate_chunked(st, rt["k"])
        engine.poll_chunked(st, with_tokens=True)
        engine.release_all(st)
        # the warm-up cohort is kept for the run: its captured step keeps
        # the engine's graph pool alive (a pool whose last graph is freed
        # cannot take the next cohort's capture; PERF.md, Open questions)
        warmed = (st, warm)
        arena = KVArena.for_engines(engine, block_tokens=ar["block_tokens"],
                                    shrink=ar["shrink"])
        executor = TimedContinuousExecutor(engine, seed=seed, arena=arena,
                                           collect_tokens=True)
        executor._bind(rec)
        runtime = ContinuousRuntime(env, policy, executor, k=rt["k"])
    else:
        raise ValueError(f"unknown runtime kind {rt['kind']!r}")
    engine._cohorts.clear()
    if on_cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    ops.reset_launch_counts()
    setup_s = time.perf_counter() - t_process
    print("set-up s: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
        + f"; before the cell's code {marks[0][1] - t_process:.3f}",
        file=sys.stderr)

    # -- the measured window ---------------------------------------------------
    rec.open()
    try:
        runtime.run(gen=traffic, n_epochs=EPOCHS, warmup_epochs=1)
        raise RuntimeError("the runtime ended before the window closed")
    except WindowClosed:
        pass
    rec.finish()
    if on_cuda:
        torch.cuda.synchronize()
    window_s = rec.t_end - rec.t_start
    counters = ops.launch_counts()
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    arena_info = None if arena is None else dict(
        alloc_peak=arena.alloc_peak, total_pages=arena.total_pages)
    view = RunView(cell, rec, dict(tier=engine.decode_tier(),
                                   captures=list(engine.captures)),
                   arena_info)
    caps = [c["ms"] for c in engine.captures]
    print(f"captures in the run: {len(caps)}, ms: "
          f"{[round(x, 1) for x in caps[-6:]]}; slowest requests ms: "
          f"{[round(1e3 * x, 1) for x in sorted(rec.latency_s)[-8:]]}",
          file=sys.stderr)
    durs = [1e3 * (c["t1"] - c["t0"]) for c in rec.calls]
    if durs:
        print(f"data-plane call ms: first {[round(d, 1) for d in durs[:4]]}"
              f", median {statistics.median(durs):.1f}, slowest "
              f"{[round(d, 1) for d in sorted(durs)[-4:]]}",
              file=sys.stderr)
    served = len(rec.latency_s)
    tokens = sum(c["tokens"] for c in rec.calls)
    print(f"window: {window_s:.3f} s, {len(rec.calls)} data-plane calls, "
          f"{served} requests served, {tokens} tokens; launches "
          f"{ {k: v for k, v in counters.items() if v} }", file=sys.stderr)

    metrics = {}
    names = [m for m in (cell["per_layer"] if trace else cell["end_to_end"])]
    for m in names:
        if trace:
            value = bench.metric_reader(m["name"])(view)
        elif m["name"] == "tokens_per_s":
            value = tokens / window_s
        elif m["name"] == "request_p95_ms":
            print(f"request_p95_ms over {served} requests (median "
                  f"{1e3 * statistics.median(rec.latency_s):.4f} ms)",
                  file=sys.stderr)
            value = 1e3 * _percentile(rec.latency_s, 95)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            raise KeyError(f"no end-to-end metric {m['name']!r}")
        if value is None:
            print(f"{m['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        key = m["name"] if on_cuda else f"cpu.{m['name']}"
        metrics[key] = {"value": value, "unit": m["unit"]}
    if trace and on_cuda:
        traced = [round(d, 1) for c, d in zip(rec.calls, durs)
                  if c["profiled"]]
        rest = [d for c, d in zip(rec.calls, durs) if not c["profiled"]]
        print(f"card: {_power_limit()}; traced sub-window: "
              f"{len(view.profiled)} data-plane calls, ms {traced} (the "
              f"profiler stretches them); the window's other calls: median "
              f"{statistics.median(rest) if rest else 0.0:.1f} ms",
              file=sys.stderr)

    # -- free the program's state, then the check ------------------------------
    del runtime, executor, engine, policy, arena, warmed
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    lim = cell["limits"]["gap_max"]["limit"]
    rows = check.sample_rows(rec.rows, int(mix["sample"]), seed)
    gaps = check.served_gaps(arch_mod, params, model, eng_kw["s_max"], rows,
                             device=dev)
    verdict = check.judge(gaps, lim)
    if keep is not None:
        keep.update(arch_module=arch_mod, params=params, model=model,
                    s_max=eng_kw["s_max"], sample=rows, gaps=gaps,
                    limit=lim, device=dev)
    checks = {"gap_max": {"value": verdict["worst"], "limit": lim}}
    print(f"compared {verdict['tokens']} served tokens of {len(rows)} "
          f"requests", file=sys.stderr)

    device_rec = {"platform": "gpu" if on_cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_cuda
                  else "cpu", "count": 1 if on_cuda else 0,
                  "memory_peak_bytes": int(memory_peak)}
    out = {"correct": verdict["correct"], "attempted": served,
           "failed": verdict["failed"],
           "metrics": metrics, "device": device_rec}
    if trace and on_cuda:
        busy, sub = view.busy_s(), view.sub_window_s()
        device_rec["busy_s"] = busy if busy is not None else 0.0
        device_rec["window_s"] = sub if sub is not None else 0.0
        out["breakdown"] = {"device_ops": view.device_ops(),
                            "idle_gaps": view.idle_gaps()}
    out["checks"] = checks
    return out


def print_checks(result: Dict) -> None:
    """The numbers compared, each beside its limit: the last lines on
    standard error."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)

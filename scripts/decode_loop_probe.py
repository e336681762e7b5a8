#!/usr/bin/env python3
"""Probe the two early-exit designs of the replayed decode loop on one card.

    python3 scripts/decode_loop_probe.py            # from the repo root

For each case (full-width BLOOM-3B at W8A16 and W8A8, BLOOM-7B1 at W8A16 on
the fused tier, depth cut to ``--layers``; B = 8, s' = 512, random weights
from a seed) it prefills one batch and runs the same masked decode steps
from the same state, several ways:

* eager: the step as PyTorch ops, one after another;
* (b) host loop: the step captured once as a CUDA graph and replayed N
  times from the host;
* (b') the same with the step inside an IF node of PyTorch's own
  conditional capture (``begin_capture_to_if_node``), where this PyTorch
  has it: a dead step then skips the model on the device;
* (a) device while: the captured step wrapped in the WHILE node of
  ``src/repro_torch/csrc/decode_loop.cu``, launched once (its iteration
  count is read back).

The step carries the loop's counter t (advanced only while the loop is
live: some row can emit and t < t_end), the rows' lengths and done, and
feeds each step's argmax to the next at one fixed position.  Every way
must end bitwise equal to eager (tokens, lengths, t).  Then every row's
cap is set to STOP < N: eager and (b) still run N steps, (b') and (a) do
not, and each way's t must be STOP.  Each case runs in a process of its
own, so that a fault in one design cannot hide the others.  Prints one
line of JSON per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CASES = {"bloom-3b:8": ("bloom-3b", 8), "bloom-3b:8,8": ("bloom-3b", (8, 8)),
         "bloom-7b1:8": ("bloom-7b1", 8)}
N, STOP, B, S_MAX, N_MAX = 24, 3, 8, 512, 128


def _ms(fn, reps: int = 3) -> float:
    """Least of ``reps`` host-clock runs of ``fn`` ending in a sync."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def run_case(name: str, layers: int) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.config import get_arch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine
    arch, bits = CASES[name]
    cfg = get_arch(arch).scaled(n_layers=layers)
    eng = ServingEngine(cfg, quant_bits=8, batch_capacity=B, s_max=S_MAX,
                        n_max=N_MAX, seed=0)
    params = eng.params_for(bits)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=S_MAX).tolist()
               for _ in range(B)]
    host = eng._prepare(prompts, [N_MAX] * B, bits)[1]
    cur0, cache = eng._prefill(params, host[:, :S_MAX].to("cuda"))
    dev = torch.device("cuda")
    cur = cur0.clone()
    lengths = torch.zeros((B,), dtype=torch.int64, device=dev)
    caps = torch.full((B,), N_MAX, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    t_end = torch.zeros((), dtype=torch.int32, device=dev)
    pos = S_MAX + N_MAX // 2

    def reset(cap: int, bound: int) -> None:
        cur.copy_(cur0)
        lengths.zero_()
        done.zero_()
        t.zero_()
        caps.fill_(cap)
        t_end.fill_(bound)

    def step() -> None:
        alive = (~done) & (lengths < caps)
        live = alive.any() & (t < t_end)
        logits, _ = eng.model.decode_step(params, cache, cur[:, None], pos)
        nxt = torch.argmax(logits[..., :cfg.vocab], -1)
        torch.where(live, nxt, cur, out=cur)
        lengths.add_(alive & live)
        t.add_(live)

    def state():
        torch.cuda.synchronize()
        return (cur.clone(), lengths.clone(), int(t))

    def same(a, b) -> bool:
        return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    and a[2] == b[2])

    out = {"case": name, "layers": layers, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "apis": {a: hasattr(torch.cuda.CUDAGraph, a) for a in (
               "raw_cuda_graph", "begin_capture_to_if_node",
               "end_capture_to_conditional_node")}}

    def eager(n):
        for _ in range(n):
            step()

    reset(N_MAX, N)
    eager(N)
    want = state()
    reset(STOP, N)
    eager(N)
    want_stop = state()
    out["eager_ms_per_step"] = _ms(lambda: (reset(N_MAX, N), eager(N))) / N
    out["eager_stop_t"] = want_stop[2]

    # warm up off the capture, with the loop dead (t_end = 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    reset(N_MAX, 0)
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool):
        step()
    graph.instantiate()
    torch.cuda.synchronize()
    out["capture_ms"] = (time.perf_counter() - t0) * 1e3

    def replay(n):
        for _ in range(n):
            graph.replay()

    reset(N_MAX, N)
    replay(N)
    out["b_equal"] = same(state(), want)
    reset(STOP, N)
    replay(N)
    got = state()
    out["b_stop_equal"] = same(got, want_stop)
    out["b_ms_per_step"] = _ms(lambda: (reset(N_MAX, N), replay(N))) / N
    out["b_stop_ms"] = _ms(lambda: (reset(STOP, N), replay(N)))
    out["b_dead_step_ms"] = _ms(lambda: (reset(0, N), replay(N))) / N

    if out["apis"]["begin_capture_to_if_node"]:
        try:
            gif = torch.cuda.CUDAGraph()
            with torch.cuda.graph(gif, pool=pool):
                live = ((~done) & (lengths < caps)).any() & (t < t_end)
                gif.begin_capture_to_if_node(live)
                step()
                gif.end_capture_to_conditional_node()

            def replay_if(n):
                for _ in range(n):
                    gif.replay()

            reset(N_MAX, N)
            replay_if(N)
            out["if_equal"] = same(state(), want)
            reset(STOP, N)
            replay_if(N)
            out["if_stop_equal"] = same(state(), want_stop)
            out["if_ms_per_step"] = _ms(lambda: (reset(N_MAX, N),
                                                 replay_if(N))) / N
            out["if_dead_step_ms"] = _ms(lambda: (reset(0, N),
                                                  replay_if(N))) / N
        except Exception as e:          # a probe: report and go on
            out["if_error"] = f"{type(e).__name__}: {e}"

    lib = _build.library("decode_loop")
    exec_ = ctypes.c_void_p()
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    rc = lib.decode_loop_build(graph.raw_cuda_graph(), t.data_ptr(),
                               t_end.data_ptr(), lengths.data_ptr(),
                               caps.data_ptr(), done.data_ptr(), B,
                               iters.data_ptr(), ctypes.byref(exec_))
    out["a_build_ms"] = (time.perf_counter() - t0) * 1e3
    out["a_build_rc"] = rc
    if rc == 0:
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = lib.decode_loop_launch(exec_, stream)
            if rc:
                raise RuntimeError(f"decode_loop_launch: CUDA error {rc}")

        try:
            reset(N_MAX, N)
            launch()
            out["a_equal"] = same(state(), want)
            reset(STOP, N)
            iters.zero_()
            launch()
            out["a_stop_equal"] = same(state(), want_stop)
            out["a_stop_iterations"] = int(iters)
            out["a_ms_per_step"] = _ms(lambda: (reset(N_MAX, N),
                                                launch())) / N
            out["a_stop_ms"] = _ms(lambda: (reset(STOP, N), launch()))
            out["a_dead_ms"] = _ms(lambda: (reset(0, N), launch()))
        except RuntimeError as e:
            out["a_error"] = str(e)
        lib.decode_loop_destroy(exec_)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--case", choices=sorted(CASES), default=None,
                    help="run one case in this process")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.case:
        print(json.dumps(run_case(args.case, args.layers)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    log = _build.build_dir() / "decode_loop.log"     # ptxas -v, if built now
    if log.exists():
        print(log.read_text().strip(), flush=True)
    rc = 0
    for case in CASES:
        p = subprocess.run([sys.executable, __file__, "--case", case,
                            "--layers", str(args.layers)],
                           capture_output=True, text=True, timeout=600)
        print(p.stdout.strip() or json.dumps(
            {"case": case, "rc": p.returncode,
             "stderr": p.stderr.strip()[-2000:]}), flush=True)
        rc |= p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""The serving benchmark of the PyTorch and CUDA port on one NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: it sets
up (weights drawn from the seed on the card, the engine, the control
plane), warms up the cell's own shapes, serves the cell's traffic for
``--seconds`` through the program's runtime, checks what was served
against the float32 reference, and prints one JSON object as the last
line of standard output.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a second, traced run.

Adding to the benchmark takes new files and new ``BENCHMARK.json``
entries, and no edit of a file that is there:

- a configuration: ``perfbench/configs/<name>.json`` (the program's arch
  id, its published source, its architecture's module under
  ``"reference"``, the model's sizes as served, the engine's shape, the
  cost model and the deployed method, ``reduced`` and ``assumed``) and
  a ``configs`` entry naming it;
- an architecture: one module, ``perfbench/reference/<name>.py``, named
  by the path from the checkout's root in each of its configurations'
  ``"reference"`` and loaded by that path.  It imports torch and the
  standard library, and nothing of JAX, of the JAX package or of the
  program, and gives: ``file_sizes(model)`` and ``program_sizes(cfg)``
  (the sizes that the configuration file's "model" block and the
  program's configuration have to agree on) and ``scaled_program(cfg,
  model)`` (the program's configuration cut to the file's sizes, for
  the CPU tests); ``make_params(model, seed, device)`` (the raw weight
  tree in the program's serving layout, drawn from the seed on the
  device); ``forward_rows(params, model, s_max, rows, device)`` (float32
  logits, TF32 off, at every served position of each row {"prompt",
  "gap", "fed", "bits"}, each at the precision spec ``bits`` its call
  was served at, as the engine resolves it: weight bits, or a (weight,
  activation) pair); ``prompt_flops(model, s)`` and ``tokens_flops(
  model, s, j0, j1)`` (the model FLOPs of served tokens);
- a traffic mix: ``perfbench/traffic/<name>.json`` (the arrivals'
  parameters, the policy spec, the runtime path with its settings, the
  size of the checked sample and the calls the traced run profiles),
  read by the one generator in ``perfbench/harness/traffic.py``;
- a cell: a ``workloads`` entry naming a configuration and a mix, and
  ``perfbench/limits/<cell>.json`` with the limit of each number its
  check compares, set from the program's and the control's readings
  (``perfbench/control.py``);
- a per-layer metric: ``perfbench/metrics/<name>.py`` whose ``read(run)``
  returns the number or None (nothing to read: the metric is left out
  of the line), and a ``per_layer`` entry; a kernel's operations and
  bytes go into ``perfbench/costs/<kernel>.py``.

The run exits with a code other than 0, and prints no result, without a
CUDA device, with fewer devices than the cell asks for, in a directory
that holds only the benchmark, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux's
    /proc/self/stat; the script's own start elsewhere)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout; no JAX
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("no program beside the benchmark (src/repro_torch is "
              "missing)", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import json

    import torch
    from perfbench.harness import bench
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    from perfbench.harness.runner import print_checks, run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark may not load "
              f"JAX or the JAX package", file=sys.stderr)
        return 4
    print_checks(result)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

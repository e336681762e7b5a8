"""Readings that set a cell's limits: the program's widest gap and the
control's, seed by seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds <n> \\
        [--first <seed>] [--seconds <s>] [--out <file.json>]

For each seed the cell runs as the benchmark runs it (a short window at
the cell's own load and sizes) and its checked sample's widest gap is
the program's reading.  On the same sample, the control puts the
reference at the next precision below each row's served one (weights
one step down: int4 for int8; activations as served) in the program's
place: it serves, at each position of the same prompts and tokens, the
token that the lower precision ranks first, and those rows go through
the same comparison and judgement as the program's
(``check.served_gaps``, ``check.judge``).  A limit lies above every
sound reading of the program and below the control's; the script exits
with 1 where a control came out correct or the program did not.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_019)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from perfbench.harness import check
    from perfbench.harness.runner import run_cell
    out = []
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        keep = {}
        t0 = time.perf_counter()
        res = run_cell(args.workload, seed, args.seconds, False,
                       time.perf_counter(), keep=keep)
        prog = res["checks"]["gap_max"]["value"]
        ctrl = check.control_verdict(keep)
        rec = dict(seed=seed, program=prog, control=ctrl["worst"],
                   rows=[float(g.max()) for g in keep["gaps"]],
                   tokens=sum(len(g) for g in keep["gaps"]),
                   correct=res["correct"], control_correct=ctrl["correct"],
                   s=time.perf_counter() - t0)
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del keep, res
        gc.collect()
        torch.cuda.empty_cache()
    lo = max(r["program"] for r in out)
    up = min(r["control"] for r in out)
    separated = all(r["correct"] and not r["control_correct"] for r in out)
    print(json.dumps(dict(workload=args.workload, lower=lo, upper=up,
                          ratio=up / lo if lo else None,
                          separated=separated)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())

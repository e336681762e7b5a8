"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) combo.

Proves the distribution config is coherent without hardware: a fake
process group of 256 or 512 ranks (``FakeStore``, backend ``"fake"``)
stands in for the 16x16 / 2x16x16 production mesh.  For each combination
the step's fake parameters, optimizer state, batch and cache are placed by
``build_step``'s specs and the step runs once over meta tensors
(``launch.steps.trace_step``) under the roofline's counters: memory per
device (fits or not), FLOPs, bytes and collective bytes (for the
§Roofline terms).  The dry run takes the plain path (float weights,
``use_kernel=False``), as the JAX package lowers its XLA path; meta
tensors launch no kernel.

Each case has a time budget (``--budget``): a step that runs past it is
recorded as not traced, with its reason, and never scaled up from the
part that ran.  Exit code 1 when a case failed.

Usage:
  python -m repro_torch.launch.dryrun                  # all pairs x 2 meshes
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --multi-pod-only --json out.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import signal
import sys
import time
import traceback
from typing import Optional, Tuple

from repro_torch.config import (ModelConfig, ShapeConfig, applicable_shapes,
                                get_arch, get_shape, list_archs)

DEFAULT_BUDGET_S = 900.0


class TraceBudgetExceeded(RuntimeError):
    """A traced step ran past its case's budget."""


@contextlib.contextmanager
def budget(seconds: Optional[float]):
    """Raise ``TraceBudgetExceeded`` in the traced step once ``seconds``
    have passed (a real-time alarm: it stops a step inside one slow op as
    well); no limit for None.  Yields a list whose first item turns True
    when the alarm fired (DTensor may wrap the exception in its own)."""
    fired = [False]
    if seconds is None:
        yield fired
        return

    def expire(signum, frame):
        fired[0] = True
        raise TraceBudgetExceeded(f"not traced whole within {seconds:g} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))
    try:
        yield fired
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0),
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(str(d) for d in shape)


def trace_case(cfg: ModelConfig, shape: ShapeConfig,
               mesh_shape: Tuple[int, ...],
               budget_s: Optional[float] = DEFAULT_BUDGET_S, **kw) -> dict:
    """One combination on a fake mesh of ``mesh_shape`` (("data", "model")
    or ("pod", "data", "model")): its §Roofline record, or, past
    ``budget_s``, ``{"traced": False, "reason": ...}``."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import trace_step
    from repro_torch.roofline.analysis import analyze_traced
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    n = 1
    for d in mesh_shape:
        n *= d
    with fake_group(n):
        mesh = _mesh("cpu", mesh_shape, axes)
        t0 = time.time()
        try:
            with budget(budget_s) as fired:
                tracer = trace_step(cfg, shape, mesh, **kw)
        except Exception:
            if not fired[0]:
                raise
            return {"traced": False, "chips": n,
                    "reason": f"not traced whole within {budget_s:g} s",
                    "t_trace_s": time.time() - t0}
        rec = analyze_traced(cfg, shape, mesh, tracer, time.time() - t0)
    rec["traced"] = True
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool,
            seq_shard_decode: bool = False, verbose: bool = True,
            kv_bits: int = 16,
            budget_s: Optional[float] = DEFAULT_BUDGET_S) -> dict:
    cfg = get_arch(arch)
    if kv_bits != 16:
        cfg = cfg.scaled(kv_bits=kv_bits)
    shape = get_shape(shape_name)
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    rec = trace_case(cfg, shape, mesh_shape, budget_s,
                     seq_shard_decode=seq_shard_decode)
    rec.update({"arch": arch, "shape": shape_name,
                "mesh": mesh_name(mesh_shape)})
    if verbose:
        if rec["traced"]:
            print(f"  mem/device: {rec['bytes_per_device'] / 2**30:.2f} GiB"
                  f" | flops: {rec['traced_flops']:.3e} | coll: "
                  f"{rec['collective_bytes']:.3e} B | trace "
                  f"{rec['t_trace_s']:.0f}s")
        else:
            print(f"  not traced: {rec['reason']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--seq-shard-decode", action="store_true",
                    help="shard long-context decode caches over 'model'")
    ap.add_argument("--kv-bits", type=int, default=16, choices=[8, 16],
                    help="int8 KV cache for decode shapes (§Perf pair 3)")
    ap.add_argument("--budget", type=float, default=DEFAULT_BUDGET_S,
                    help="seconds a case may trace before it is recorded "
                         "as not traced")
    ap.add_argument("--json", default=None, help="write results to file")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(list_archs(assigned_only=True))
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    results, not_traced, failures = [], [], []
    for arch in archs:
        cfg = get_arch(arch)
        shapes = [args.shape] if args.shape else list(applicable_shapes(cfg))
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
                print(f"[dryrun] {tag}", flush=True)
                try:
                    rec = run_one(arch, shape_name, mp, args.seq_shard_decode,
                                  kv_bits=args.kv_bits,
                                  budget_s=args.budget)
                except Exception as e:
                    traceback.print_exc()
                    failures.append({"case": tag, "error": repr(e)})
                    continue
                (results if rec["traced"] else not_traced).append(rec)

    print(f"\n[dryrun] {len(results)} ok, {len(not_traced)} not traced, "
          f"{len(failures)} failed")
    for r in not_traced:
        print(f"  NOT TRACED {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['reason']}")
    for f in failures:
        print(f"  FAIL {f['case']}: {f['error'][:200]}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"results": results, "not_traced": not_traced,
                       "failures": failures}, fh, indent=1)
        print(f"[dryrun] wrote {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

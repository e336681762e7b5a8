#!/usr/bin/env python3
"""Time full-width BLOOM-3B's W8A16 decode step, over the slab and over the
paged arena, for several checkouts in turns on one NVIDIA GPU, so that two
versions of the port are compared inside one run on one card.

Run from the root of a checkout:

    python3 scripts/decode_step_ab.py --trees build/parent,.,.,build/parent

Each entry runs in a process of its own with ``<tree>/src`` first on the
path (its kernels are built into ``<tree>/build``).  It builds BLOOM-3B at
full width (random weights from seed 0, B = 8, s' = 512, n_max = 128),
prefills the batch, and times one decode step eager (the mean of 8 after 2
warm-up steps, host clock around work that ends in a synchronize; and the
median and least of 31 steps each timed alone) and as one CUDA-graph
replay (device work), at the first decode position over the slab and at
position 576 over an arena of 16-slot pages; then the host time of one
decode-attention call over the slab and over the arena (the median and
least of 21 rounds of 50 calls enqueued on an idle card; the host clock
stops before the synchronize).  Prints one JSON line per entry and a
table at the end.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def eager_ms(fn, n: int = 31):
    """(median, least) of n eager runs of fn, each timed alone on the host
    clock from an idle card to its synchronize."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2], min(times)


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena

    cfg = get_arch("bloom-3b")
    with torch.no_grad():
        engine = ServingEngine(cfg, quant_bits=8, seed=0, batch_capacity=8,
                               s_max=cs.S_MAX, n_max=cs.N_MAX, device="cuda")
        prompts, _ = cs._prompts(cfg, cs.BATCH, cs.S_MAX, cs.N_MAX)
        slab = cs.decode_step_timing(engine, prompts, 8, "W8A16")
        params = engine.params_for(8)
        host = engine._prepare(prompts, [engine.n_max] * len(prompts), 8)[1]
        cur0, cache = engine._prefill(params,
                                      host[:, :engine.s_max].to("cuda"))
        slab_eager = eager_ms(lambda: engine._decode(params, cache, cur0, 0))
        del cache
        arena = KVArena.for_engines(engine, block_tokens=cs.PAGED["bt"])
        st = engine.start_chunked(prompts, [engine.n_max] * len(prompts),
                                  quant_bits=8, arena=arena)
        engine._extend_leases(st, engine.n_max)
        pages, table = arena.buffers(), st.table.device
        pos = engine.s_max + engine.n_max // 2
        cur = st.cur[:, None]

        def step(i=0):
            return engine.model.decode_step_paged(params, pages, table, cur,
                                                  pos)

        def steps(n=8):
            for _ in range(n):
                step()

        steps(2)
        _, paged_ms = cs._timed(steps)
        paged_dev = cs.device_ms(step)
        paged_eager = eager_ms(step)
        # host time of one attention call (wrapper and launches), at the
        # step's shapes: rounds of 50 calls enqueued on an idle card, each
        # timed before its synchronize, so that the card never holds the
        # host back; the median round and the least
        from repro_torch.kernels import ops
        a = cs.ATTN
        q = torch.randn((8, a["nh"], a["dh"]), device="cuda",
                        dtype=torch.bfloat16)
        kv = torch.randn((2, 8, a["W"], a["nkv"], a["dh"]), device="cuda",
                         dtype=torch.bfloat16)
        kp, vp = (leaf[0][..., :a["nkv"], :a["dh"]]
                  for leaf in (pages["k"], pages["v"]))
        host_us = {}
        for name, call in (
                ("flash_decode", lambda: ops.flash_decode(q, kv[0], kv[1],
                                                          pos + 1)),
                ("flash_decode_paged", lambda: ops.flash_decode_paged(
                    q, kp, vp, table, pos + 1))):
            call()
            rounds = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    call()
                rounds.append((time.perf_counter() - t0) * 1e6 / 50)
            torch.cuda.synchronize()
            host_us[name] = sorted(rounds)[len(rounds) // 2]
            host_us[name + "_least"] = min(rounds)
        engine.release_all(st)
    return dict(tree=str(tree), step_ms=slab["decode_ms_per_step"],
                step_median_ms=slab_eager[0], step_least_ms=slab_eager[1],
                step_device_ms=slab["decode_device_ms_per_step"],
                paged_step_ms=paged_ms / 8,
                paged_step_median_ms=paged_eager[0],
                paged_step_least_ms=paged_eager[1],
                paged_step_device_ms=paged_dev,
                host_us_per_call=host_us,
                device=torch.cuda.get_device_name(0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", help="comma-separated checkouts, in turns")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(Path(args.one).resolve())), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    rows = []
    for tree in args.trees.split(","):
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        print(f"{r['tree']}: slab step {r['step_ms']:.2f} ms eager "
              f"(median {r['step_median_ms']:.2f}, least "
              f"{r['step_least_ms']:.2f}), "
              f"{r['step_device_ms']:.3f} ms device; paged step "
              f"{r['paged_step_ms']:.2f} ms eager "
              f"(median {r['paged_step_median_ms']:.2f}, least "
              f"{r['paged_step_least_ms']:.2f}), "
              f"{r['paged_step_device_ms']:.3f} ms device; one call "
              f"{r['host_us_per_call']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

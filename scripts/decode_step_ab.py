#!/usr/bin/env python3
"""Time full-width BLOOM-3B's W8A16 decode step, over the slab and over the
paged arena (with ``--w8a8`` its W8A8 step, with ``--w4a16`` its W4A16
step on a 4-bit engine), or with ``--model
bloom_7b1`` BLOOM-7B1's W8A16 and W8A8 steps on the fused tier (K6 over the
slab, K7 over the arena), for several checkouts in turns on one NVIDIA GPU,
so that two versions of the port are compared inside one run on one card.

Run from the root of a checkout:

    python3 scripts/decode_step_ab.py --trees build/parent,.,.,build/parent
    python3 scripts/decode_step_ab.py --w8a8 --trees build/parent,.,.,build/parent
    python3 scripts/decode_step_ab.py --w4a16 --trees build/parent,.,.,build/parent
    python3 scripts/decode_step_ab.py --model bloom_7b1 \
        --trees build/parent,.,.,build/parent

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
stops before the synchronize).  With ``--w8a8`` it also times the W8A8 step
at the first decode position over the slab the same ways, its device work
split in place between ``quantize_rowwise`` and K2
(``chip_smoke.w8a8_decode_breakdown``), each of K2's six calls of a layer at
decode (``chip_smoke.decode_call_ms``), and the host time of one K2 call at
the wq shape.  With ``--w4a16`` it builds a 4-bit engine on the same
weights and times its W4A16 step at the first decode position over the
slab, eager (mean of 8; median and least of 31) and as one CUDA-graph
replay, and K3's six calls of a layer at decode one by one.  BLOOM-7B1
(the same batch, random weights from seed 0) takes
W8A16 and W8A8 each at the first decode position over the slab and at
position 576 over an arena of 16-slot pages: device work as one CUDA-graph
replay, the eager median and least of 31 steps, and the launches of one
step (the fused kernel must run in every layer).  Prints one JSON line per
entry and a table at the end.
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


def one(tree: Path, w8a8: bool = False, w4a16: bool = False) -> dict:
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
        a8 = w8a8_step(engine, prompts, host_us) if w8a8 else None
        a4 = w4a16_step(engine, prompts) if w4a16 else None
    return dict(tree=str(tree), step_ms=slab["decode_ms_per_step"],
                step_median_ms=slab_eager[0], step_least_ms=slab_eager[1],
                step_device_ms=slab["decode_device_ms_per_step"],
                paged_step_ms=paged_ms / 8,
                paged_step_median_ms=paged_eager[0],
                paged_step_least_ms=paged_eager[1],
                paged_step_device_ms=paged_dev,
                host_us_per_call=host_us, w8a8=a8, w4a16=a4,
                device=torch.cuda.get_device_name(0))


def one_7b1(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena

    cfg = get_arch("bloom-7b1")
    out = dict(tree=str(tree), device=torch.cuda.get_device_name(0))
    with torch.no_grad():
        engine = ServingEngine(cfg, quant_bits=8, seed=0, batch_capacity=8,
                               s_max=cs.S_MAX, n_max=cs.N_MAX, device="cuda")
        prompts, _ = cs._prompts(cfg, cs.BATCH, cs.S_MAX, cs.N_MAX)
        for label, bits in (("W8A16", 8), ("W8A8", (8, 8))):
            params = engine.params_for(bits)
            host = engine._prepare(prompts, [engine.n_max] * len(prompts),
                                   bits)[1]
            cur, cache = engine._prefill(params,
                                         host[:, :engine.s_max].to("cuda"))

            def slab(i=0):
                return engine._decode(params, cache, cur, 0)

            slab()
            ops.reset_launch_counts()
            slab()
            slab_calls = ops.launch_counts()
            slab_dev = cs.device_ms(slab)
            slab_eager = eager_ms(slab)
            del cache
            arena = KVArena.for_engines(engine, block_tokens=cs.PAGED["bt"])
            st = engine.start_chunked(prompts, [engine.n_max] * len(prompts),
                                      quant_bits=bits, arena=arena)
            engine._extend_leases(st, engine.n_max)
            pages, table = arena.buffers(), st.table.device
            pos = engine.s_max + engine.n_max // 2
            cur_p = st.cur[:, None]

            def paged(i=0):
                return engine.model.decode_step_paged(params, pages, table,
                                                      cur_p, pos)

            paged()
            ops.reset_launch_counts()
            paged()
            paged_calls = ops.launch_counts()
            paged_dev = cs.device_ms(paged)
            paged_eager = eager_ms(paged)
            engine.release_all(st)
            del arena, pages, table, st
            torch.cuda.empty_cache()
            n = cfg.n_layers
            if slab_calls["flash_decode_fused"] != n \
                    or paged_calls["flash_decode_fused_paged"] != n:
                raise RuntimeError(f"{label}: a step missed the fused tier: "
                                   f"slab {slab_calls}, paged {paged_calls}")
            out[label] = dict(
                step_device_ms=slab_dev, step_median_ms=slab_eager[0],
                step_least_ms=slab_eager[1], paged_step_device_ms=paged_dev,
                paged_step_median_ms=paged_eager[0],
                paged_step_least_ms=paged_eager[1])
    return out


def w8a8_step(engine, prompts, host_us):
    """The W8A8 decode step at the first position over the slab: eager (mean
    of 8 after 2 warm-up steps; median and least of 31), device work, its
    in-place split between quantize_rowwise and K2, K2's six decode calls of
    a layer one by one, and (into ``host_us``) the host time of one K2
    call."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.quant import ptq
    bits = (8, 8)
    params = engine.params_for(bits)
    host = engine._prepare(prompts, [engine.n_max] * len(prompts), bits)[1]
    cur, cache = engine._prefill(params, host[:, :engine.s_max].to("cuda"))

    def steps(n=8):
        c = cur
        for t in range(n):
            c, _ = engine._decode(params, cache, c, t)

    steps(2)
    _, step_ms = cs._timed(steps)
    median, least = eager_ms(lambda: engine._decode(params, cache, cur, 0))
    dev = cs.device_ms(lambda i: engine._decode(params, cache, cur, 0))
    in_decode = cs.w8a8_decode_breakdown(engine, params, cache, cur)
    del cache
    calls = cs.decode_call_ms("w8a8")
    K = N = engine.cfg.d_model
    x = torch.randn((cs.DECODE_M, K), device="cuda").to(torch.bfloat16)
    xq, sx = ptq.quantize_rowwise(x)
    q = torch.zeros((K, N), dtype=torch.int8, device="cuda")
    s = torch.ones((N,), device="cuda")
    call = lambda: qm.quant_matmul_a8_cuda(xq, sx, q, s, torch.bfloat16)  # noqa
    call()
    rounds = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        rounds.append((time.perf_counter() - t0) * 1e6 / 50)
    torch.cuda.synchronize()
    host_us["w8a8_decode_call"] = sorted(rounds)[len(rounds) // 2]
    host_us["w8a8_decode_call_least"] = min(rounds)
    return dict(step_ms=step_ms / 8, step_median_ms=median,
                step_least_ms=least, step_device_ms=dev, in_decode=in_decode,
                k2_calls_ms=calls, k2_layer_ms=sum(calls.values()))


def w4a16_step(engine, prompts):
    """The W4A16 decode step at the first position over the slab, on a
    4-bit engine built from ``engine``'s weights: eager (mean of 8 after 2
    warm-up steps; median and least of 31), device work (one CUDA-graph
    replay), and K3's six decode calls of a layer one by one."""
    import chip_smoke as cs
    from repro_torch.serving.engine import ServingEngine
    e4 = ServingEngine(engine.cfg, params=engine._raw_params, quant_bits=4,
                       batch_capacity=engine.batch_capacity,
                       s_max=engine.s_max, n_max=engine.n_max, device="cuda")
    params = e4.params_for(4)
    host = e4._prepare(prompts, [e4.n_max] * len(prompts), 4)[1]
    cur, cache = e4._prefill(params, host[:, :e4.s_max].to("cuda"))

    def steps(n=8):
        c = cur
        for t in range(n):
            c, _ = e4._decode(params, cache, c, t)

    steps(2)
    _, step_ms = cs._timed(steps)
    median, least = eager_ms(lambda: e4._decode(params, cache, cur, 0))
    dev = cs.device_ms(lambda i: e4._decode(params, cache, cur, 0))
    del cache, e4, params
    calls = cs.decode_call_ms("w4a16")
    return dict(step_ms=step_ms / 8, step_median_ms=median,
                step_least_ms=least, step_device_ms=dev, k3_calls_ms=calls,
                k3_layer_ms=sum(calls.values()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", help="comma-separated checkouts, in turns")
    ap.add_argument("--w8a8", action="store_true",
                    help="also time the W8A8 step and K2's decode calls")
    ap.add_argument("--w4a16", action="store_true",
                    help="also time the W4A16 step and K3's decode calls")
    ap.add_argument("--model", choices=("bloom_3b", "bloom_7b1"),
                    default="bloom_3b")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        tree = Path(args.one).resolve()
        print(json.dumps(one_7b1(tree) if args.model == "bloom_7b1"
                         else one(tree, args.w8a8, args.w4a16)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    rows = []
    for tree in args.trees.split(","):
        out = subprocess.run([sys.executable, __file__, "--one", tree,
                              "--model", args.model]
                             + (["--w8a8"] if args.w8a8 else [])
                             + (["--w4a16"] if args.w4a16 else []),
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        if args.model == "bloom_7b1":
            print(r["tree"] + ": " + "; ".join(
                f"{k} step {v['step_device_ms']:.3f} ms device, eager median "
                f"{v['step_median_ms']:.2f} least {v['step_least_ms']:.2f}; "
                f"paged {v['paged_step_device_ms']:.3f} ms device, eager "
                f"median {v['paged_step_median_ms']:.2f} least "
                f"{v['paged_step_least_ms']:.2f}"
                for k, v in r.items() if k in ("W8A16", "W8A8")))
            continue
        print(f"{r['tree']}: slab step {r['step_ms']:.2f} ms eager "
              f"(median {r['step_median_ms']:.2f}, least "
              f"{r['step_least_ms']:.2f}), "
              f"{r['step_device_ms']:.3f} ms device; paged step "
              f"{r['paged_step_ms']:.2f} ms eager "
              f"(median {r['paged_step_median_ms']:.2f}, least "
              f"{r['paged_step_least_ms']:.2f}), "
              f"{r['paged_step_device_ms']:.3f} ms device; one call "
              f"{r['host_us_per_call']}")
        if r["w8a8"]:
            a = r["w8a8"]
            print(f"    W8A8 step {a['step_ms']:.2f} ms eager (median "
                  f"{a['step_median_ms']:.2f}, least {a['step_least_ms']:.2f})"
                  f", {a['step_device_ms']:.3f} ms device (in place: "
                  f"quantize_rowwise {a['in_decode']['quantize_rowwise_ms']:.3f}"
                  f", K2 {a['in_decode']['kernel_ms']:.3f}); K2 decode layer "
                  f"{a['k2_layer_ms']:.4f} ms {a['k2_calls_ms']}")
        if r["w4a16"]:
            a = r["w4a16"]
            print(f"    W4A16 step {a['step_ms']:.2f} ms eager (median "
                  f"{a['step_median_ms']:.2f}, least {a['step_least_ms']:.2f})"
                  f", {a['step_device_ms']:.3f} ms device; K3 decode layer "
                  f"{a['k3_layer_ms']:.4f} ms {a['k3_calls_ms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

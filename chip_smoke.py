#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Run from the root of a checkout, with nothing built beforehand:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Device: the script needs CUDA; it prints the card's name and power limit
   as ``nvidia-smi`` reports them.
2. Build: every ``src/repro_torch/csrc/*.cu`` is compiled with ``nvcc`` for
   ``sm_90a`` into ``build/repro_torch/`` (one ``nvcc`` per source, all at
   once).
3. Kernels: each hand-written kernel is held against its plain PyTorch
   version at the shapes BLOOM-3B's serving path gives it (decode M = 8 and
   prefill M = 8 * 512 for the quantized matmuls; B = 8, W = 640, 32 heads
   of 80 for decode attention, over a slab and, paged, through a block
   table of 16-slot pages) and timed beside its bound, its plain version
   and one PyTorch library call.  The paged kernel must also be bitwise
   equal to the slab kernel on the gathered slab, and read the leading
   corner of a wider (32, 128) page tail in place.
4. Small reference: a reduced float32 BLOOM served on the card through the
   kernels gives the same greedy tokens as the same weights served on the
   CPU through the plain versions, slab and paged.
5. Slice: full-width BLOOM-3B (30 layers, d_model 2560, vocab 250,880,
   bfloat16, random weights from a seed) serves a few epochs through
   ``EpochRuntime`` + ``EngineExecutor``, three ways: ``dftsp`` at W8A16
   (the default), ``dftsp:quant=auto,split=true`` (the scheduler picks the
   method per epoch, W8A8 among them) and ``dftsp`` deployed at W4A16 on a
   4-bit engine.  Each run is counted on its own: the launch counters are
   zeroed just before it and read just after, and each kernel must have
   launched in the run that reaches its tier.  ``generate`` must equal
   ``generate_reference`` at each quantized precision.
6. Continuous slice: the same W8 engine serves through ``ContinuousRuntime``
   + ``EngineContinuousExecutor`` over a paged KV arena of half the slab's
   pages (``dftsp``, chunk k = 16), counted on its own: the paged decode
   kernel and W8A16 must launch, the slab decode kernel must not, requests
   are conserved and every page is back on the free list after the drain.
   On the same engine, chunked decode over the arena, chunked decode over
   the slab and ``generate`` give bitwise equal tokens, and so do a paged
   and a slab cohort refilled at step 40.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and tensor-core
# operations/s by operand type.  Bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}

# BLOOM-3B serving shapes: one layer's quantized matmuls as (name, K, N)
LAYER_MATMULS = [("wq", 2560, 2560), ("wk", 2560, 2560), ("wv", 2560, 2560),
                 ("wo", 2560, 2560), ("w1", 2560, 10240), ("w2", 10240, 2560)]
BATCH, S_MAX, N_MAX = 8, 512, 128
DECODE_M, PREFILL_M = BATCH, BATCH * S_MAX
# decode attention: the cache holds s_max + n_max slots; a decode step at
# position p reads p + 1 of them, 576 on average over the n_max steps
ATTN = dict(B=BATCH, nh=32, nkv=32, dh=80, W=S_MAX + N_MAX,
            n_valid=S_MAX + N_MAX // 2)

# Both sides sum in float32 and round once to the output type: bf16 outputs
# may differ by one bf16 ulp of the output (2^-7 relative) plus the float32
# summation error (measured below 4e-6 at these shapes).
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
F32_TOL = dict(rtol=1e-4, atol=1e-4)        # summation order only
# the paged path: 16-slot pages, an arena of half the slab's pages (the
# size KVArena.for_engines(engine, 16, shrink=0.5) gives the main engine)
PAGED = dict(bt=16, shrink=0.5, tail=(32, 128))
# the library yardstick rounds its probabilities to bf16 before P @ V
LIBRARY_TOL = dict(rtol=2 ** -7, atol=1e-2)
ROTATE_BYTES = 256e6                        # > 5x the 50 MB L2


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def device_ms(fn, n_inputs: int = 1, budget_s: float = 0.05) -> float:
    """Device time of one ``fn(i)`` in ms.  The calls, cycling over
    ``n_inputs`` input sets (so that weights come from device memory, not
    the L2), are captured into one CUDA graph and replayed under CUDA
    events: no host work sits between the launches, so small kernels are
    timed by the device and not by Python's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        for i in range(2):
            fn(i % n_inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0)
        torch.cuda.synchronize()
        est = max(time.perf_counter() - t0, 1e-6)
    torch.cuda.current_stream().wait_stream(side)
    reps = max(n_inputs, min(200, int(budget_s / est)))
    reps = math.ceil(reps / n_inputs) * n_inputs
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[op_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _assert_close(got, want, tol, what):
    try:
        torch.testing.assert_close(got, want, **tol)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: kernel disagrees with its plain "
                           f"version: {e}") from None


def quant_matmul_phase(tier: str):
    """K1 (w8a16), K2 (w8a8) or K3 (w4a16) at BLOOM-3B's layer shapes."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.quant import ptq
    bits = 4 if tier == "w4a16" else 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err, f32_err = 0.0, 0.0
    acc = {phase: dict(ms=0.0, plain=0.0, lib_bf16=0.0, lib_int8=0.0,
                       nb=0.0, no=0.0)
           for phase in ("decode", "prefill")}
    for K, N in sorted({(k, n) for _, k, n in LAYER_MATMULS}):
        count = sum(1 for _, k, n in LAYER_MATMULS if (k, n) == (K, N))
        w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
        t = ptq.quantize(w, bits)
        q, s = t.q, t.scale.reshape(-1)
        wd = ptq.dequantize(ptq.QTensor(q, t.scale, bits, (K, N),
                                        torch.bfloat16))
        n_copy = max(1, min(64, math.ceil(ROTATE_BYTES / q.numel())))
        qs = [q.clone() for _ in range(n_copy)]
        # torch._int_mm's layout for its second operand: column-major
        qts = [c.t().contiguous().t() for c in qs] if tier == "w8a8" else []
        n_dense = max(1, min(64, math.ceil(ROTATE_BYTES / (2 * wd.numel()))))
        wds = [wd.clone() for _ in range(n_dense)]
        for phase, M in (("decode", DECODE_M), ("prefill", PREFILL_M)):
            x = torch.randn((M, K), generator=gen, device=dev)
            xb = x.to(torch.bfloat16)
            if tier == "w8a8":
                xq, sx = ptq.quantize_rowwise(xb)
                got = qm.quant_matmul_a8_cuda(xq, sx, q, s, torch.bfloat16)
                want = qm.quant_matmul_a8_plain(xq, sx, q, s, torch.bfloat16)
                check(torch.equal(got, want),
                      f"w8a8 M={M} K={K} N={N}: not bitwise equal to the "
                      f"plain version (max err {_max_err(got, want)})")
                run = lambda i: qm.quant_matmul_a8_cuda(  # noqa: E731
                    xq, sx, qs[i], s, torch.bfloat16)
                plain = lambda i: qm.quant_matmul_a8_plain(  # noqa: E731
                    xq, sx, qs[i], s, torch.bfloat16)
                n_bytes = M * K + 4 * M + K * N + 4 * N + 2 * M * N
            else:
                got = qm.quant_matmul_cuda(xb, q, s, bits)
                want = qm.quant_matmul_plain(xb, q, s, bits)
                _assert_close(got, want, BF16_TOL,
                              f"{tier} M={M} K={K} N={N} bf16")
                if phase == "decode":
                    g32 = qm.quant_matmul_cuda(x, q, s, bits)
                    w32 = qm.quant_matmul_plain(x, q, s, bits)
                    _assert_close(g32, w32, F32_TOL,
                                  f"{tier} M={M} K={K} N={N} f32")
                    f32_err = max(f32_err, _max_err(g32, w32))
                run = lambda i: qm.quant_matmul_cuda(  # noqa: E731
                    xb, qs[i], s, bits)
                plain = lambda i: qm.quant_matmul_plain(  # noqa: E731
                    xb, qs[i], s, bits)
                n_bytes = 2 * M * K + q.numel() + 4 * N + 2 * M * N
            max_err = max(max_err, _max_err(got, want))
            lib = lambda i: torch.matmul(xb, wds[i])  # noqa: E731
            # decode streams cold weights; prefill is bound by operations
            n_rot, n_rot_dense = (n_copy, n_dense) if phase == "decode" \
                else (1, 1)
            a = acc[phase]
            a["ms"] += count * device_ms(run, n_rot)
            a["plain"] += count * device_ms(plain, n_rot)
            a["lib_bf16"] += count * device_ms(lib, n_rot_dense)
            if tier == "w8a8" and M > 16:
                # the library's int8 GEMM (it takes M > 16 only) and the
                # same writeout; its int32 product must be exact too
                check(torch.equal(torch._int_mm(xq, qts[0]),
                                  qm.a8_accumulate_plain(xq, q)),
                      f"torch._int_mm M={M} K={K} N={N} is not exact")
                lib8 = lambda i: (  # noqa: E731
                    torch._int_mm(xq, qts[i]).float() * sx
                    * s.reshape(1, -1)).to(torch.bfloat16)
                a["lib_int8"] += count * device_ms(lib8, n_rot)
            else:
                a["lib_int8"] = None
            a["nb"] += count * n_bytes
            a["no"] += count * 2.0 * M * N * K
        del qs, qts, wds
    out = {}
    for phase, a in acc.items():
        b, by = bound_ms(a["nb"], a["no"], "int8" if tier == "w8a8"
                         else "bf16")
        if a["lib_int8"] is None:
            lib_ms, call = a["lib_bf16"], ("torch.matmul, bf16, on the "
                                           "dequantized weight")
        else:
            lib_ms, call = a["lib_int8"], ("torch._int_mm + the rowwise "
                                           "scales")
        out[phase] = dict(ms=a["ms"], plain_ms=a["plain"], library_ms=lib_ms,
                          library_call=call, bound_ms=b, bound_by=by)
        if a["lib_int8"] is not None:
            out[phase]["library_bf16_ms"] = a["lib_bf16"]
    tol = "bitwise" if tier == "w8a8" else \
        f"bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}; " \
        f"f32 rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g})"
    return max_err, tol, out


def flash_decode_phase():
    """K4 at BLOOM-3B's decode shape (B=8, W=640, nh=nkv=32, dh=80)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    B, nh, nkv, dh, W, nv = (ATTN[k] for k in ("B", "nh", "nkv", "dh", "W",
                                               "n_valid"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err, f32_err = 0.0, 0.0
    q = torch.randn((B, nh, dh), generator=gen, device=dev)
    k = torch.randn((B, W, nkv, dh), generator=gen, device=dev)
    v = torch.randn((B, W, nkv, dh), generator=gen, device=dev)
    rows = torch.randint(1, W + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    for n_valid in (nv, W, 1, rows):
        g32 = fd.flash_decode_cuda(q, k, v, n_valid)
        w32 = fd.flash_decode_plain(q, k, v, n_valid)
        _assert_close(g32, w32, F32_TOL, "flash_decode f32")
        f32_err = max(f32_err, _max_err(g32, w32))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    for n_valid in (nv, W, rows):
        got = fd.flash_decode_cuda(qb, kb, vb, n_valid)
        want = fd.flash_decode_plain(qb, kb, vb, n_valid)
        _assert_close(got, want, BF16_TOL, "flash_decode bf16")
        max_err = max(max_err, _max_err(got, want))
    n_copy = max(1, min(32, math.ceil(ROTATE_BYTES / (2 * kb.numel() * 2))))
    kvs = [(kb.clone(), vb.clone()) for _ in range(n_copy)]
    run = lambda i: fd.flash_decode_cuda(qb, *kvs[i], nv)  # noqa: E731
    plain = lambda i: fd.flash_decode_plain(qb, *kvs[i], nv)  # noqa: E731
    q4 = qb[:, :, None]                                  # (B, nh, 1, dh)
    lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q4, kvs[i][0][:, :nv].transpose(1, 2),
        kvs[i][1][:, :nv].transpose(1, 2))
    # the library call computes the same function (the first nv slots)
    _assert_close(lib(0)[:, :, 0], plain(0), LIBRARY_TOL,
                  "scaled_dot_product_attention yardstick")
    n_bytes = 2 * (2 * B * nh * dh + 2 * B * nv * nkv * dh)
    n_ops = 4.0 * B * nh * nv * dh
    b, by = bound_ms(n_bytes, n_ops, "bf16")
    out = dict(ms=device_ms(run, n_copy),
               plain_ms=device_ms(plain, n_copy),
               library_ms=device_ms(lib, n_copy),
               library_call="torch.nn.functional.scaled_dot_product_attention",
               bound_ms=b, bound_by=by)
    tol = (f"bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}; f32 "
           f"rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g})")
    return max_err, tol, out


def flash_decode_paged_phase():
    """K5 at BLOOM-3B's decode shape through a block table: B=8, 40 blocks
    of 16 slots (W=640), 32 heads of 80, over an arena of 162 pages."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serving.kv_arena import N_RESERVED
    B, nh, nkv, dh, W, nv = (ATTN[k] for k in ("B", "nh", "nkv", "dh", "W",
                                               "n_valid"))
    bt = PAGED["bt"]
    n_b = W // bt
    P = N_RESERVED + math.ceil(B * n_b * PAGED["shrink"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    # each row's blocks on a random permutation of the allocatable pages
    table = torch.stack([N_RESERVED + torch.randperm(
        P - N_RESERVED, generator=gen, device=dev)[:n_b]
        for _ in range(B)]).to(torch.int32)
    tl = table.long()

    def gather(pages):
        return pages[tl].reshape((B, W) + tuple(pages.shape[2:]))

    q = torch.randn((B, nh, dh), generator=gen, device=dev)
    kp = torch.randn((P, bt, nkv, dh), generator=gen, device=dev)
    vp = torch.randn((P, bt, nkv, dh), generator=gen, device=dev)
    rows = torch.randint(1, W + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    max_err, f32_err = 0.0, 0.0
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, kp, vp))
        ks, vs = gather(kd), gather(vd)
        for n_valid in (nv, W, 1, rows):
            got = fd.flash_decode_paged_cuda(qd, kd, vd, table, n_valid)
            want = fd.flash_decode_paged_plain(qd, kd, vd, table, n_valid)
            f32 = dt == torch.float32
            _assert_close(got, want, F32_TOL if f32 else BF16_TOL,
                          f"flash_decode_paged {dt}")
            if f32:
                f32_err = max(f32_err, _max_err(got, want))
            else:
                max_err = max(max_err, _max_err(got, want))
            check(torch.equal(got, fd.flash_decode_cuda(qd, ks, vs, n_valid)),
                  f"flash_decode_paged {dt} n_valid={n_valid}: not bitwise "
                  f"equal to flash_decode on the gathered slab")
    # a wider page tail, read through its leading corner in place
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    wide = [torch.zeros((P, bt) + PAGED["tail"], dtype=torch.bfloat16,
                        device=dev) for _ in range(2)]
    wide[0][..., :nkv, :dh] = kb
    wide[1][..., :nkv, :dh] = vb
    kc, vc = (w[..., :nkv, :dh] for w in wide)
    check(not kc.is_contiguous(), "the corner view should be strided")
    got = fd.flash_decode_paged_cuda(qb, kc, vc, table, rows)
    _assert_close(got, fd.flash_decode_paged_plain(qb, kc, vc, table, rows),
                  BF16_TOL, "flash_decode_paged on a (32, 128)-tail corner")
    check(torch.equal(got, fd.flash_decode_paged_cuda(qb, kb, vb, table,
                                                      rows)),
          "flash_decode_paged on a corner view != on the contiguous pages")
    # timing: arenas rotated through > 256 MB; k and v of one arena stacked
    # so that the yardstick gathers both in one call
    n_copy = max(1, min(32, math.ceil(ROTATE_BYTES / (2 * kb.numel() * 2))))
    kvs = [torch.stack([kb, vb]) for _ in range(n_copy)]
    run = lambda i: fd.flash_decode_paged_cuda(  # noqa: E731
        qb, kvs[i][0], kvs[i][1], table, nv)
    plain = lambda i: fd.flash_decode_paged_plain(  # noqa: E731
        qb, kvs[i][0], kvs[i][1], table, nv)
    q4 = qb[:, :, None]                                  # (B, nh, 1, dh)

    def lib(i):
        g = kvs[i][:, tl].reshape(2, B, W, nkv, dh)      # one gather
        return F.scaled_dot_product_attention(
            q4, g[0, :, :nv].transpose(1, 2), g[1, :, :nv].transpose(1, 2))

    _assert_close(lib(0)[:, :, 0], plain(0), LIBRARY_TOL,
                  "page gather + scaled_dot_product_attention yardstick")
    n_bytes = 2 * (2 * B * nh * dh + 2 * B * nv * nkv * dh) + 4 * B * n_b
    n_ops = 4.0 * B * nh * nv * dh
    b, by = bound_ms(n_bytes, n_ops, "bf16")
    out = dict(ms=device_ms(run, n_copy),
               plain_ms=device_ms(plain, n_copy),
               library_ms=device_ms(lib, n_copy),
               library_call="page gather kv[:, table] + torch.nn.functional."
                            "scaled_dot_product_attention, timed together",
               bound_ms=b, bound_by=by, arena_pages=P)
    tol = (f"bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}; f32 "
           f"rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g}); "
           f"bitwise == flash_decode on the gathered slab (f32 and bf16); "
           f"(32, 128)-tail corner read in place")
    return max_err, tol, out


KERNELS = [
    # (name, counter, source, replaces, the main path whose run its
    # "launches" reports)
    ("quant_matmul_w8a16", "w8a16", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "dftsp_w8a16"),
    ("quant_matmul_w8a8", "w8a8", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97", "dftsp_auto_split"),
    ("quant_matmul_w4a16", "w4a16", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:79", "dftsp_w4a16"),
    ("flash_decode", "flash_decode", "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:40", "dftsp_w8a16"),
    ("flash_decode_paged", "flash_decode_paged",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:403", "continuous_w8a16"),
]


def kernel_phase():
    results = {}
    for name, counter, *_ in KERNELS:
        if counter == "flash_decode":
            err, tol, t = flash_decode_phase()
            shape = (f"B={ATTN['B']} W={ATTN['W']} n_valid={ATTN['n_valid']} "
                     f"nh=nkv={ATTN['nh']} dh={ATTN['dh']} bf16, one call "
                     f"(one layer of a decode step)")
        elif counter == "flash_decode_paged":
            err, tol, t = flash_decode_paged_phase()
            shape = (f"B={ATTN['B']} {ATTN['W'] // PAGED['bt']} blocks of "
                     f"{PAGED['bt']} slots (W={ATTN['W']}) n_valid="
                     f"{ATTN['n_valid']} nh=nkv={ATTN['nh']} dh={ATTN['dh']} "
                     f"bf16 over {t['arena_pages']} pages, one call (one "
                     f"layer of a decode step)")
        else:
            err, tol, both = quant_matmul_phase(counter)
            t = dict(both["decode"])
            t.update({f"prefill_{k}": v for k, v in both["prefill"].items()})
            shape = (f"one BLOOM-3B layer: 4 x (K=N=2560) + (2560->10240) + "
                     f"(10240->2560), M={DECODE_M} decode "
                     f"(prefill_*: M={PREFILL_M}), bf16")
        results[name] = dict(max_abs_err=err, tolerance=tol, shape=shape, **t)
        log(f"{name}: max_abs_err={err:.4g} ({tol}); ms={t['ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f}"
            + (f"; prefill ms={t['prefill_ms']:.3f} bound_ms="
               f"{t['prefill_bound_ms']:.3f} ({t['prefill_bound_by']}) "
               f"plain_ms={t['prefill_plain_ms']:.3f} library_ms="
               f"{t['prefill_library_ms']:.3f}" if "prefill_ms" in t else ""))
    return results


# ---------------------------------------------------------------------------
# Serving phases
# ---------------------------------------------------------------------------


def small_reference_phase():
    """Reduced float32 BLOOM: card (kernels) == CPU (plain versions)."""
    from repro_torch import bridge
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena
    import numpy as np
    cfg = get_arch("bloom-3b").scaled(n_layers=2, d_model=256, n_heads=4,
                                      n_kv_heads=4, d_ff=512, vocab=2048,
                                      dtype="float32")
    kw = dict(batch_capacity=4, s_max=32, n_max=16, quant_bits=8,
              use_kernel=True)
    cpu = ServingEngine(cfg, device="cpu", seed=4, **kw)
    gpu = ServingEngine(cfg, params=bridge.to_device(cpu._raw_params, "cuda"),
                        device="cuda", **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist()
               for n in (7, 32, 19, 3)]
    caps = [16, 9, 16, 4]
    for bits in (0, 8, (8, 8), 4):
        a = gpu.generate(prompts, caps, quant_bits=bits)
        b = cpu.generate(prompts, caps, quant_bits=bits)
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.lengths, b.lengths),
              f"reduced float32 BLOOM at bits={bits}: card tokens "
              f"{a.tokens.tolist()} != CPU tokens {b.tokens.tolist()}")
    a = gpu.generate_via_chunks(prompts, caps, k=5, quant_bits=8,
                                arena=KVArena.for_engines(gpu, 8))
    b = cpu.generate_via_chunks(prompts, caps, k=5, quant_bits=8,
                                arena=KVArena.for_engines(cpu, 8))
    check(np.array_equal(a.tokens, b.tokens)
          and np.array_equal(a.lengths, b.lengths),
          f"reduced float32 BLOOM, paged: card tokens {a.tokens.tolist()} "
          f"!= CPU tokens {b.tokens.tolist()}")
    log("small reference: reduced float32 BLOOM, card == CPU tokens at "
        "bits 0, 8, (8, 8), 4, and paged (8-slot pages, k=5) at bits 8")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# The main path, three ways: (label, the method the env deploys, policy
# spec, the engine's weight bits, counters that must launch in the run,
# counters that must not).  Each run is counted on its own.
MAIN_PATHS = [
    ("dftsp_w8a16", "W8A16", "dftsp", 8, ("w8a16", "flash_decode"),
     ("w8a8", "w4a16")),
    ("dftsp_auto_split", "W8A16", "dftsp:quant=auto,split=true", 8,
     ("w8a8", "flash_decode"), ()),
    ("dftsp_w4a16", "W4A16-GPTQ", "dftsp", 4, ("w4a16", "flash_decode"),
     ("w8a16", "w8a8")),
]


def serve_paths(engines, rate: float, n_epochs: int):
    """Each main path under ``EpochRuntime`` + ``EngineExecutor``, with the
    launch counters zeroed just before it and read just after."""
    from repro_torch.core.environment import paper_env
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.runtime import EngineExecutor, EpochRuntime
    runs = {}
    for label, method, spec, bits, launched, idle in MAIN_PATHS:
        runtime = EpochRuntime(paper_env("bloom-3b", method), get_policy(spec),
                               EngineExecutor(engines[bits], seed=0))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = runtime.run(rate=rate, n_epochs=n_epochs, seed=0,
                        warmup_epochs=0)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        log(f"slice: {label}: {spec} deployed at {method} on a W{bits} "
            f"engine, {n_epochs} epochs at rate {rate}: served={m.served} "
            f"dropped={m.dropped} truncated={m.truncated} "
            f"tokens={m.generated_tokens} batches={m.batch_sizes} "
            f"methods={m.served_by_method} in {run_ms:.0f} ms; "
            f"launches {counts}")
        check(m.served > 0 and m.generated_tokens > 0,
              f"{label} served nothing: {m.served} requests, "
              f"{m.generated_tokens} tokens")
        for c in launched:
            check(counts[c] > 0, f"{label}: {c} was never launched "
                  f"(launches {counts})")
        for c in idle:
            check(counts[c] == 0, f"{label}: {c} launched {counts[c]} "
                  f"times on a path that does not serve it")
        runs[label] = dict(served=m.served, dropped=m.dropped,
                           truncated=m.truncated, tokens=m.generated_tokens,
                           batches=m.batch_sizes,
                           methods=m.served_by_method, run_ms=run_ms,
                           launches=counts)
    return runs


def continuous_phase(engine, rate: float = 10.0, n_epochs: int = 3,
                     k: int = 16):
    """``dftsp`` through ``ContinuousRuntime`` + ``EngineContinuousExecutor``
    over a paged arena of half the slab's pages, counted on its own."""
    from repro_torch.core.environment import paper_env
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_arena import KVArena
    from repro_torch.serving.runtime import (ContinuousRuntime,
                                             EngineContinuousExecutor)
    arena = KVArena.for_engines(engine, block_tokens=PAGED["bt"],
                                shrink=PAGED["shrink"])
    runtime = ContinuousRuntime(
        paper_env("bloom-3b", "W8A16"), "dftsp",
        EngineContinuousExecutor(engine, seed=0, arena=arena), k=k)
    topups0 = engine.lease_topups
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = runtime.run(rate=rate, n_epochs=n_epochs, seed=0, warmup_epochs=0)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    log(f"continuous: dftsp over a {arena.n_pages}-page arena "
        f"({PAGED['bt']}-slot pages, {PAGED['shrink']}x the slab), k={k}, "
        f"{n_epochs} epochs at rate {rate}: served={m.served} "
        f"dropped={m.dropped} shed={m.shed} tokens={m.generated_tokens} "
        f"mid-epoch admissions={m.admitted_mid_epoch} top-up pages="
        f"{m.kv_topup_pages} alloc_peak={arena.alloc_peak} mean block "
        f"occupancy={m.mean_block_occupancy:.4f} methods="
        f"{m.served_by_method} in {run_ms:.0f} ms; launches {counts}")
    check(m.served > 0 and m.generated_tokens > 0,
          f"continuous run served nothing: {m.served} requests, "
          f"{m.generated_tokens} tokens")
    for c in ("flash_decode_paged", "w8a16"):
        check(counts[c] > 0, f"continuous: {c} was never launched "
              f"(launches {counts})")
    check(counts["flash_decode"] == 0,
          f"continuous: flash_decode launched {counts['flash_decode']} times "
          f"though every cohort is arena-backed")
    check(m.arrived == m.served + m.dropped + m.shed
          + len(m.final_queue_rids) + len(m.in_flight_rids),
          f"continuous: requests not conserved: arrived {m.arrived}, served "
          f"{m.served}, dropped {m.dropped}, shed {m.shed}, queued "
          f"{len(m.final_queue_rids)}, in flight {len(m.in_flight_rids)}")
    check(arena.free_pages == arena.total_pages,
          f"continuous: {arena.total_pages - arena.free_pages} pages still "
          f"leased after the drain")
    check(m.kv_topup_pages == engine.lease_topups - topups0,
          "continuous: top-up pages disagree with the engine's count")
    return dict(served=m.served, dropped=m.dropped, shed=m.shed,
                tokens=m.generated_tokens,
                admitted_mid_epoch=m.admitted_mid_epoch,
                topup_pages=m.kv_topup_pages, alloc_peak=arena.alloc_peak,
                arena_pages=arena.n_pages,
                mean_block_occupancy=m.mean_block_occupancy,
                methods=m.served_by_method, run_ms=run_ms, launches=counts)


def paged_equivalence_phase(engine, prompts, caps, k: int = 16):
    """Chunked decode over the arena (K5), over the slab (K4) and
    ``generate`` give bitwise equal tokens at W8A16; so do a paged and a
    slab cohort refilled at step 40.  Also times one paged decode step,
    eager and as a CUDA-graph replay."""
    import numpy as np
    from repro_torch.serving.kv_arena import ZERO_PAGE, KVArena
    arena = KVArena.for_engines(engine, block_tokens=PAGED["bt"])
    (g, s, p), ms = zip(*(_timed(fn) for fn in (
        lambda: engine.generate(prompts, caps),
        lambda: engine.generate_via_chunks(prompts, caps, k=k),
        lambda: engine.generate_via_chunks(prompts, caps, k=k,
                                           arena=arena))))
    for name, r in (("slab", s), ("paged", p)):
        check(np.array_equal(r.tokens, g.tokens)
              and np.array_equal(r.lengths, g.lengths),
              f"generate_via_chunks ({name}, k={k}) != generate at W8A16")
    half = len(prompts) // 2

    def refilled(arena):
        st = engine.start_chunked(prompts[:half], caps[:half], arena=arena)
        st = engine.generate_chunked(st, 40)
        st = engine.refill_chunked(st, list(range(half, len(prompts))),
                                   prompts[half:], caps[half:], t_now=40)
        while True:
            st = engine.generate_chunked(st, k)
            out, lengths, done, t = engine.poll_chunked(st)
            if engine.exhausted(lengths, done, st.caps_host, t):
                break
        if arena is not None:
            engine.release_all(st)
        return out, lengths

    (so, sl), (po, pl) = refilled(None), refilled(arena)
    check(np.array_equal(so, po) and np.array_equal(sl, pl),
          "paged cohort refilled at step 40 != slab cohort refilled at 40")
    check(arena.free_pages == arena.total_pages,
          "paged equivalence: pages still leased")
    check(all(not leaf[:, ZERO_PAGE].any()
              for leaf in arena.buffers().values()),
          "the zero page was written")
    log(f"paged == slab == generate at W8A16 ({len(prompts)} rows, k={k}): "
        f"generate {ms[0]:.0f} ms, chunked slab {ms[1]:.0f} ms, chunked "
        f"paged {ms[2]:.0f} ms; refilled at t=40 (rows {half}..): paged == "
        f"slab, lengths {pl.tolist()}")

    # one paged decode step of a full cohort at the mid position, eager and
    # with no host work between its kernels
    params = engine.params_for(8)
    st = engine.start_chunked(prompts, [engine.n_max] * len(prompts),
                              arena=arena)
    engine._extend_leases(st, engine.n_max)
    pages, table = arena.buffers(), st.table.device
    pos = engine.s_max + engine.n_max // 2
    cur = st.cur[:, None]

    def step(i=0):
        return engine.model.decode_step_paged(params, pages, table, cur, pos)

    def steps(n=8):
        for _ in range(n):
            step()

    steps(2)                                              # warm
    _, step_ms = _timed(steps)
    step_ms /= 8
    dev_ms = device_ms(step)
    engine.release_all(st)
    log(f"paged decode step (B={len(prompts)}, pos={pos}): {step_ms:.2f} ms "
        f"eager, {dev_ms:.2f} ms of device work (idle share "
        f"{1.0 - dev_ms / step_ms:.3f})")
    return dict(generate_ms=ms[0], chunked_slab_ms=ms[1],
                chunked_paged_ms=ms[2], paged_step_ms=step_ms,
                paged_step_device_ms=dev_ms,
                paged_step_idle_share=1.0 - dev_ms / step_ms)


def slice_phase(cfg, device="cuda", batch=BATCH, s_max=S_MAX,
                n_max=N_MAX, rate: float = 10.0, n_epochs: int = 4):
    """Serve ``cfg`` through the main paths; returns what it measured."""
    import numpy as np
    from repro_torch.models import transformer
    from repro_torch.quant import ptq
    from repro_torch.serving.engine import ServingEngine

    kw = dict(batch_capacity=batch, s_max=s_max, n_max=n_max, device=device)
    engine, init_ms = _timed(lambda: ServingEngine(cfg, quant_bits=8, seed=0,
                                                   **kw))
    log(f"slice: {cfg.arch_id} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}) built and quantized "
        f"to W8 in {init_ms:.0f} ms")
    engine4 = ServingEngine(cfg, params=engine._raw_params, quant_bits=4,
                            **kw)
    runs = serve_paths({8: engine, 4: engine4}, rate, n_epochs)

    # generate == generate_reference at each quantized precision
    rng = np.random.default_rng(0)
    lens = [s_max] + rng.integers(1, s_max + 1, size=batch - 1).tolist()
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
    caps = [n_max] + rng.integers(1, n_max + 1, size=batch - 1).tolist()
    for bits in (8, (8, 8), 4):
        a = engine.generate(prompts, caps, quant_bits=bits)
        b = engine.generate_reference(prompts, caps, quant_bits=bits)
        check(a.tokens.shape == (batch, n_max)
              and ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
              and (a.lengths >= 1).all()
              and (a.lengths <= np.minimum(caps, n_max)).all(),
              f"bits={bits}: generated tokens out of range or lengths "
              f"{a.lengths} outside [1, caps]")
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.lengths, b.lengths),
              f"generate != generate_reference on full-width BLOOM-3B at "
              f"bits={bits}")
    log(f"slice: generate == generate_reference at W8A16, W8A8 and W4A16 "
        f"({batch} rows, {n_max} tokens)")

    runs["continuous_w8a16"] = continuous_phase(engine)
    paged = paged_equivalence_phase(engine, prompts, caps)

    # end-to-end costs per precision: prefill, then decode per step
    timings = {}
    host = engine._prepare(prompts, [n_max] * batch, None)[1]
    tokens = host[:, :s_max].to(device)
    for label, bits in (("W8A16", 8), ("W8A8", (8, 8)), ("W4A16", 4),
                        ("BF16", 0)):
        params = engine.params_for(bits)
        engine._prefill(params, tokens)                   # warm
        (cur, cache), pre_ms = _timed(
            lambda: engine._prefill(params, tokens))

        def steps(n=8):
            c = cur
            for t in range(n):
                c, _ = engine._decode(params, cache, c, t)

        steps(2)                                          # warm
        _, step_ms = _timed(steps)
        step_ms /= 8
        # the same step with no host work between its kernels
        dev_ms = device_ms(lambda i: engine._decode(params, cache,
                                                           cur, 0))
        _, gen_ms = _timed(lambda: engine.generate(
            prompts, [n_max] * batch, quant_bits=bits))
        timings[label] = dict(prefill_ms=pre_ms, generate_ms=gen_ms,
                              decode_ms_per_step=step_ms,
                              decode_device_ms_per_step=dev_ms,
                              decode_idle_share=1.0 - dev_ms / step_ms)
        log(f"slice: {label}: prefill (M={batch * s_max}) {pre_ms:.1f} ms; "
            f"decode step {step_ms:.2f} ms eager, {dev_ms:.2f} ms of device "
            f"work (idle share {1.0 - dev_ms / step_ms:.3f}); generate of "
            f"{n_max} tokens x {batch} rows {gen_ms:.1f} ms")
        del cache

    # the tied unembedding: x @ dequant(embed).T on a kept bf16 table
    emb = engine.params_for(8)["embed"]
    x = torch.randn((batch, 1, cfg.d_model), device=device, dtype=emb.dtype)
    _, deq_ms = _timed(lambda: ptq.dequantize(emb))
    unembed = dict(
        dequantize_once_ms=deq_ms,
        matmul_ms=device_ms(lambda i: transformer._unembed(
            cfg, engine.params_for(8), x)),
        table_bytes=emb.dense().numel() * emb.dense().element_size())
    log(f"slice: tied unembedding at B={batch}: kept {cfg.dtype} table "
        f"{unembed['table_bytes'] / 1e9:.3f} GB read per step in "
        f"{unembed['matmul_ms']:.3f} ms; dequantizing it takes "
        f"{deq_ms:.1f} ms (not done per step)")
    return dict(runs=runs, timings=timings, unembed=unembed, paged=paged)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        log(f"FAILED: no src/repro_torch beside {Path(__file__).name}; run "
            f"it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is False: this script "
            "measures the CUDA kernels and has no CPU mode")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} "
        f"visible)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    with torch.no_grad():
        kernels = kernel_phase()
        small_reference_phase()
        from repro_torch.config import get_arch
        cfg = get_arch("bloom-3b")
        check(cfg.d_model == 2560 and cfg.n_layers == 30
              and cfg.vocab == 250880 and cfg.dtype == "bfloat16",
              f"unexpected bloom-3b config {cfg}")
        sl = slice_phase(cfg)
    log(f"summary: {json.dumps(sl)}")

    rows = []
    for name, counter, source, replaces, path in KERNELS:
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sl["runs"][path]["launches"][counter],
            launches_path=path,
            launches_by_path={label: run["launches"][counter]
                              for label, run in sl["runs"].items()},
            **kernels[name]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        code = 1
    sys.exit(code)

#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Run from the root of a checkout, with nothing built beforehand:

    python3 chip_smoke.py
    python3 chip_smoke.py --parent build/parent   # and time the parent's

``--parent`` names a checkout of the parent commit (``git archive`` into a
directory that ``.gitignore`` lists): its quantized matmuls' decode calls
and its fused decode attention (K6/K7, a16 and a8) are then timed by that
tree in a process of its own, in the same run on the same card, beside
this tree's.

Phases (any failure exits non-zero and prints no result):

1. Device: the script needs CUDA; it prints the card's name and power limit
   as ``nvidia-smi`` reports them.
2. Build: every ``src/repro_torch/csrc/*.cu`` is compiled with ``nvcc`` for
   ``sm_90a`` into ``build/repro_torch/`` (one ``nvcc`` per source, all at
   once); what ``-Xptxas -v`` said of the tensor-core kernels (``qmm_tc``,
   ``qmm_a8_wgmma``), of the GEMVs (``qmm_a8_gemv`` and ``qmm_a16_gemv``,
   which must not spill), of the split-KV decode attention (``fd_split``,
   ``fd_combine``) and of the fused decode attention (``fused_decode``,
   14 instantiations, which must not spill) is printed.
3. Kernels: each hand-written kernel is held against its plain PyTorch
   version and timed beside its bound, its plain version and the library
   call (or composition of calls) that computes the same function.  K1-K5
   at the shapes BLOOM-3B's serving path gives them (decode M = 8 and
   prefill M = 8 * 512 for the quantized matmuls, where K1, K2 and K3 run
   the tensor-core kernels, also at BLOOM-7B1's prefill layer, held bitwise
   row-invariant in M and deterministic (K2 bitwise equal to its plain
   version), and timed beside the CUDA-core kernel they replaced; the W8A8
   tier's eager ``quantize_rowwise`` is timed at the same shapes; at decode
   each of the layer's six calls is timed apart, the GEMVs (K2 on
   ``qmm_a8_gemv``, K1 and K3 with bf16 x on ``qmm_a16_gemv``) also at
   BLOOM-7B1's layer, their rows bitwise the same at M = 1 and M = 8 and
   two calls bitwise equal, every bf16 decode call counted by its GEMV;
   float32 x at decode still runs ``qmm_skinny``; B = 8,
   W = 640, 32 heads
   of 80 for decode attention, over a slab and, paged, through a block
   table of 16-slot pages); the paged kernel must be bitwise equal to the
   slab kernel on the gathered slab and read the leading corner of a wider
   (32, 128) page tail in place.  K4 and K5 are also checked at n_valid on
   each side of a split boundary, their rows must be bitwise the same
   alone, in the batch and over a wider window, and both are also timed at
   BLOOM-7B1's 32 heads of 128.  The fused int8 tier K6 (slab) and K7
   (paged) at BLOOM-7B1's decode shape (B = 8, W = 640, 32 heads of 128,
   D = 4096, int8 weights), W8A16 and W8A8, bf16 and float32, at positions
   0, 576, 640 and 647 (the eviction slot): K7 bitwise equal to K6 on the
   gathered slab and read through a wider tail's corner; K6 also at 32 x
   80 (BLOOM-3B's geometry, which the gate keeps off the tier); K4 and K5
   also at d_head 128.  The transformer family's other shapes: K6/K7 at
   internvl2-26b's (D 6144, 48 heads of 128 over 8, G = 6) and
   deepseek-coder-33b's (D 7168, 56 over 8, G = 7) decode shapes, a16 and
   a8, one cluster of 8 blocks per KV head, K7 == K6 bitwise; K4 at
   qwen3-1.7b's (16 x 128 over 8) and granite-moe-1b-a400m's (16 x 64 over
   8) geometry, K5 at qwen3's; K1 and K2 at granite's router (K 1024, N
   32) on the GEMVs at decode and the tensor cores at prefill, K2 bitwise.
   The decode glue (``add_norm``, ``rope_qk_write``) at BLOOM-3B's,
   BLOOM-7B1's and Zamba2-7B-Instruct's widths (RMSNorm at 3584 and at
   7168, 32 heads of 224), and ``mamba2_decode`` at Zamba2-7B-Instruct's
   decode layer against ``mamba2.decode_between``, its op chain.
4. Small reference: reduced float32 BLOOM-3B (all precisions) and
   BLOOM-7B1 (d_head 128, the fused tier at W8A16 and W8A8) served on the
   card through the kernels give the same greedy tokens as the same
   weights served on the CPU through the plain versions, slab and paged;
   so do the six new configs at the test suite's reduced shapes
   (deepseek-coder-33b, mistral-large-123b, qwen3-1.7b and qwen3 at
   kv_bits=8, mixtral-8x22b with a window of 16: MoE and SWA together,
   granite-moe-1b-a400m, internvl2-26b), at every precision, paged where
   ``paged_capable``.
5. Slice: full-width BLOOM-3B (30 layers, d_model 2560, vocab 250,880,
   bfloat16, random weights from a seed) serves four epochs through
   ``EpochRuntime`` + ``EngineExecutor``, three ways: ``dftsp`` at W8A16
   (the default), ``dftsp:quant=auto,split=true`` (the scheduler picks the
   method per epoch, W8A8 among them) and ``dftsp`` deployed at W4A16 on a
   4-bit engine.  Each run is counted on its own: the launch counters are
   zeroed just before it and read just after, and each kernel must have
   launched in the run that reaches its tier; a run that served W8A16,
   W4A16 or W8A8 must have prefilled on the tensor cores, and a decode-only
   window must launch no tensor-core kernel.  ``generate`` must equal
   ``generate_reference`` at each quantized precision.  One W8A8 prefill
   (here and at BLOOM-7B1) runs with CUDA events around each call of
   ``quantize_rowwise`` and of K2: their time and share inside the prefill;
   one W8A8 decode step, captured as a CUDA graph with the same events,
   gives their device time and share inside the step.  Every W8A8 call at
   M <= 8 must have run the GEMV (its counter ``w8a8_gemv``), and so must
   every W8A16 and W4A16 call at M <= 8 (``w8a16_gemv``, ``w4a16_gemv``).
   Every served path runs its decode steps as the device loop (a captured
   step in the WHILE node of ``csrc/decode_loop.cu``; ``decode_loop``
   counts its launches, and each iteration adds the step's kernel
   launches when the loop's count is read back).  At each precision
   ``generate`` runs with the engine's eager loop and with the device loop
   in the same call, in turns (three at W8A16, one at W8A8, W4A16 and
   bf16): ms, ms a step, the capture ms and the idle share against the
   step's device time; their tokens must be equal.  One decode step of
   each loop is traced with ``torch.profiler``: the top 15 device ops and
   the device busy share.  One cohort whose row 0 emits the EOS at step 3
   (the others capped at 16) must stop where ``generate_reference``'s
   loop stops: the same tokens, and as many loop iterations and the same
   ``t`` as the oracle's steps.
6. Continuous slice: the same W8 engine serves through ``ContinuousRuntime``
   + ``EngineContinuousExecutor`` over a paged KV arena of half the slab's
   pages (``dftsp``, chunk k = 16), counted on its own: the paged decode
   kernel and W8A16 must launch, the slab decode kernel must not, requests
   are conserved and every page is back on the free list after the drain.
   On the same engine, chunked decode over the arena, chunked decode over
   the slab and ``generate`` give bitwise equal tokens, and so do a paged
   and a slab cohort refilled at step 40; a full paged cohort runs with
   the eager loop and with the device loop in three turns.
7. BLOOM-7B1 (30 layers, d_model 4096, 32 heads of 128, bf16), once
   BLOOM-3B's engines are freed, on a W8 engine (B = 8, s' = 512, n_max =
   128), each path counted on its own: ``dftsp`` epochs at W8A16 (K6 and
   W8A16 launch, no unfused decode kernel); ``dftsp`` continuously at W8A16
   over an arena of half the slab's pages (K7); and
   ``dftsp:quant=auto,split=true,calib=measured`` continuously over the
   arena, which calibrates on the card at the start of the run (measured
   betas, alphas and swap costs, printed with the methods the scheduler
   picked per cohort; the launches of calibration and of serving are
   reported apart).  ``generate == generate_reference`` and paged == slab
   == ``generate`` (with a cohort refilled at step 40) at W8A16 and W8A8.
   The decode step is timed eager and as one CUDA graph, fused and with the
   fused gate forced off; ``generate`` at W8A16 and W8A8 and a paged
   W8A16 cohort with the eager loop against the device loop, once each.
   W8A16 and W8A8 must hold one kept embedding table between them; the
   kept tables' bytes per precision are printed.
8. The transformer family's other members at full width and depth, one
   after another, each engine freed before the next (B = 8, s' = 512,
   n_max = 128, bf16, random weights from a seed), each path counted on
   its own: qwen3-1.7b (28 layers, qk-norm, tied vocab 151,936) with
   ``dftsp`` epochs at W8A16 (K1, K4; no K6) and continuously over an
   arena of half the slab's pages (K5), then the same weights with the
   int8 KV cache as epochs and continuously over an arena with scale
   pages (no K4, K5, K6 or K7; tier "kv8"); granite-moe-1b-a400m (24
   layers, 32 experts top-8) with ``dftsp`` epochs at W8A16 and
   ``dftsp:quant=auto,split=true`` epochs, slab only, two replays of one
   captured MoE step bitwise equal and chunked == ``generate``;
   internvl2-26b (48 layers, 256 zero patch embeddings ahead of each
   prompt) with ``dftsp`` epochs at W8A16 (K6) and continuously over the
   arena (K7), and its device memory peak.  ``generate ==
   generate_reference`` on each engine (at each precision on granite),
   paged == slab == ``generate`` on the paged-capable ones; the decode
   step eager and as one CUDA graph, and ``generate`` with the eager loop
   against the device loop; one step each of qwen3 at kv_bits=8, granite
   and internvl2 traced with ``torch.profiler`` (top 15 device ops).
9. The recurrent, hybrid and audio families at full width and depth, one
   after another, each engine freed before the next, zamba2-7b last (B =
   8, s' = 512, n_max = 128, bf16): xlstm-1.3b (48 blocks, 3.65 B
   parameters, mLSTM state 5.6 GB a cohort), whisper-tiny (4 + 4 layers,
   1500 zero audio frames a prompt) and zamba2-7b (81 Mamba2 layers and 13
   shared-attention sites).  Their quantized trees are dequantized at load
   and their decode runs no kernel, as in the JAX package: on every path
   the device loop launches and no K1-K7 counter moves.  Each: ``generate
   == generate_reference`` at bf16 and W8A16 on the first ``generate``
   after each capture; chunked (k = 16) == ``generate``; a row refilled
   mid-cohort at step 16 equals the same prompt refilled into a cohort
   with no other live row (xLSTM: and the prompt served alone); ``dftsp``
   epochs at W8A16 and ``dftsp`` through ``ContinuousRuntime`` on the slab
   (k = 16); prefill ms, the decode step eager and as one CUDA graph,
   ``generate`` with the eager loop against the device loop, the idle
   share; one step traced (top 15 device ops); the device memory peak.
   The small-reference phase (4) also serves the three reduced at float32
   (xlstm-1.3b at 9 layers, zamba2-7b at 13): card == CPU tokens at every
   precision.  Then zamba2-7b-instruct, the published block (81 Mamba2
   layers of two groups, two shared blocks at 13 sites over concat(x,
   embedding)), W8A16: ``generate == generate_reference`` on the first
   ``generate`` after its capture; ``dftsp`` epochs counted on their own
   (``mamba2_decode``, ``add_norm``, ``rope_qk_write``, K4 at each site
   (13 a step) and the device loop launch, no other K1-K7 counter moves:
   its KERNELS rows' launches); one decode step's kernel calls and its
   eager and device ms; the memory peak.
10. Training (M10), after zamba2-7b-instruct is freed and outside
   ``no_grad``;
   float weights, so no K1-K7 counter (nor the decode loop) may move.
   (a) One reduced float32 model of each family (olmo-1b, qwen3-1.7b,
   granite-moe-1b-a400m, internvl2-26b, xlstm-1.3b and zamba2-7b with
   every kind of block at 5 layers, whisper-tiny) trains 3 steps through
   ``Trainer`` on the card and on the CPU from the same weights and
   batches: the loss every step, and grad_norm and lr at the first, within
   1e-4 (relative); grad_norm after the first update within 1e-3.
   (c) olmo-1b's (params, AdamW state) go through a checkpoint and back
   onto the card, bitwise.  (b) Full-width OLMo-1B (16 layers, d_model
   2048, tied vocab 50,304, bf16, 1.18 B parameters) trains 30 steps
   through ``repro_torch.launch.train.main`` at its defaults (batch 16,
   seq 256, lr 3e-4, remat on): every loss finite, the last below the
   first; ms a step (median of steps 2..N), tokens/s and the memory peak;
   then one step through ``Trainer`` with remat off from the same seed,
   its loss and grad_norm within 1e-3 of the first launcher step's, and
   its memory peak; then the launcher's step (remat on) on that state,
   its forward + backward and AdamW update timed apart beside their
   bounds, and one step traced with ``torch.profiler`` (top 15 kernels).

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# phase 10's medians (ms a step) on an NVIDIA H100 80GB HBM3 at 700 W
# while the launcher still ran without a mesh, beside which phase 11
# prints this run's launcher steps through the mesh of one
UNMESHED_OLMO_STEP_MS = (244.83, 271.74)

# BLOOM-3B serving shapes: one layer's quantized matmuls as (name, K, N)
LAYER_MATMULS = [("wq", 2560, 2560), ("wk", 2560, 2560), ("wv", 2560, 2560),
                 ("wo", 2560, 2560), ("w1", 2560, 10240), ("w2", 10240, 2560)]
# BLOOM-7B1's (d_model 4096, d_ff 16384)
LAYER_MATMULS_7B1 = [("wq", 4096, 4096), ("wk", 4096, 4096),
                     ("wv", 4096, 4096), ("wo", 4096, 4096),
                     ("w1", 4096, 16384), ("w2", 16384, 4096)]
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
# BLOOM-7B1's decode step, the fused tier's shape: one layer's attention
ATTN7 = dict(B=BATCH, D=4096, nh=32, nkv=32, dh=128, W=S_MAX + N_MAX,
             n_valid=S_MAX + N_MAX // 2)
# a wider page tail than BLOOM-7B1's (32, 128), read through its corner
TAIL7 = (40, 160)
# the library composition of the fused function rounds q, k, v and the
# attention output to bf16 between its calls: held by the relative error
# of the whole output
LIBRARY_REL = 0.03
# the transformer family's other decode shapes, B = 8, W = 640: K4/K5 at
# qwen3-1.7b's 16 heads of 128 over 8 KV heads (G = 2) and at
# granite-moe-1b-a400m's 16 of 64 over 8; K6/K7 at internvl2-26b's (D 6144,
# 48 of 128 over 8, G = 6) and at deepseek-coder-33b's (D 7168, 56 of 128
# over 8, G = 7), one cluster of 8 blocks per KV head
ATTN_QWEN3 = dict(ATTN, nh=16, nkv=8, dh=128)
ATTN_GRANITE = dict(ATTN, nh=16, nkv=8, dh=64)
ATTN_INTERNVL2 = dict(ATTN7, D=6144, nh=48, nkv=8)
ATTN_DEEPSEEK = dict(ATTN7, D=7168, nh=56, nkv=8)
FAMILY_ATTN = {"qwen3": (ATTN_QWEN3, 22), "granite": (ATTN_GRANITE, 23)}
# granite-moe-1b-a400m's router: d_model 1024 -> 32 experts
ROUTER_MATMULS = [("router", 1024, 32)]
# Zamba2-7B-Instruct's decode step (B = 8, W = 640): a site's attention
# (32 heads of 224 over 32, from the 7168-wide concat(x, embedding)) and
# the widths of its RMSNorms (3584; 7168 over the concatenation)
ATTN_ZAMBA2 = dict(ATTN, D=3584, nh=32, nkv=32, dh=224)
ZAMBA2_SCALE = (224 / 2) ** -0.5        # a site's logit scale, (dh / 2)^-1/2
# the new configs of the port, each reduced for the small-reference phase
FAMILY_ARCHS = ("deepseek-coder-33b", "mistral-large-123b", "qwen3-1.7b",
                "mixtral-8x22b", "granite-moe-1b-a400m", "internvl2-26b")
# the recurrent, hybrid and audio families for the small-reference phase:
# reduced, xlstm-1.3b and zamba2-7b deep enough to hold every kind of block
# (an sLSTM block; two shared-attention sites and a tail)
RECURRENT_SMALL = (("xlstm-1.3b", dict(n_layers=9)),
                   ("zamba2-7b", dict(n_layers=13)), ("whisper-tiny", {}))
# the training phase: one reduced model of each family at float32 (xLSTM
# and Zamba2 with every kind of block at 5 layers), card against CPU over
# TRAIN_SMALL_STEPS steps, relative: the loss every step, and grad_norm and
# lr at the first step (the same weights: float32 sums in other orders),
# within TRAIN_TOL; grad_norm after the first update within
# TRAIN_TOL_LATER (Adam's normalised step turns a gradient element near
# zero, where the devices' sums differ most against it, into an update of
# full size, so the devices' weights part: reduced zamba2-7b's grad_norm
# read 1.07e-4 apart at step 2 on an H100, every other model <= 4.2e-6);
# full-width OLMo-1B for TRAIN_STEPS steps, remat on against off within
# TRAIN_FULL_TOL (bf16, the same weights and batch)
TRAIN_SMALL = (("olmo-1b", {}), ("qwen3-1.7b", {}),
               ("granite-moe-1b-a400m", {}), ("internvl2-26b", {}),
               ("xlstm-1.3b", dict(n_layers=5, xlstm=dict(slstm_every=2))),
               ("zamba2-7b", dict(n_layers=5, hybrid=dict(attn_every=2))),
               ("whisper-tiny", {}))
TRAIN_SMALL_STEPS, TRAIN_STEPS = 3, 30
TRAIN_TOL, TRAIN_TOL_LATER, TRAIN_FULL_TOL = 1e-4, 1e-3, 1e-3


T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since the start."""
    print(f"[chip_smoke {time.perf_counter() - T0:.1f} s] {msg}", flush=True)


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
    """The least ms for the work: bytes over the card's HBM rate and
    operations over its dense tensor-core peak for ``op_type``, from the
    port's record ``config.H100`` (NVIDIA's H100 SXM data sheet)."""
    from repro_torch.config import H100, H100_INT8_OPS
    t_bytes = n_bytes / H100.hbm_bw
    t_ops = n_ops / {"bf16": H100.peak_flops, "int8": H100_INT8_OPS}[op_type]
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


def _tiled_a16(x, q, s, bits):
    """The CUDA-core tiled kernel on bf16 x at M > 8, called directly: the
    prefill design the tensor-core kernel replaced, timed beside it."""
    from repro_torch.kernels import _build
    M, K = x.shape
    N = s.numel()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((0,), dtype=torch.float32, device=x.device)
    rc = _build.library("quant_matmul").qmm_a16(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        part.data_ptr(), M, N, K, bits, 1, 1, K,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "qmm_a16")
    return out


def _tiled_a8(xq, sx, q, s):
    """The CUDA-core tiled kernel on int8 xq at M > 8, bf16 out, called
    directly: the prefill design the tensor-core kernel replaced, timed
    beside it."""
    from repro_torch.kernels import _build
    M, K = xq.shape
    N = s.numel()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    rc = _build.library("quant_matmul").qmm_a8(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), M, N, K, 1, 0, 1, K,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "qmm_a8")
    return out


def decode_call_ms(tier: str, layer=LAYER_MATMULS, seed: int = 21):
    """Device ms of each of a layer's quantized matmuls at decode (M = 8,
    bf16 x and out), one by one: K1 (w8a16), K2 (w8a8, on ``quantize_rowwise``
    of x) or K3 (w4a16), weights rotated through copies that outsize the
    L2.  Inputs come from ``seed`` alone, so a parent tree given the same
    arguments (``parent_decode_call_ms``) times the same work."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.quant import ptq
    bits = 4 if tier == "w4a16" else 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, K, N in layer:
        w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
        t = ptq.quantize(w, bits)
        q, s = t.q, t.scale.reshape(-1)
        xb = torch.randn((DECODE_M, K), generator=gen, device=dev).to(
            torch.bfloat16)
        n_copy = max(1, min(64, math.ceil(ROTATE_BYTES / q.numel())))
        qs = [q.clone() for _ in range(n_copy)]
        if tier == "w8a8":
            xq, sx = ptq.quantize_rowwise(xb)
            run = lambda i: qm.quant_matmul_a8_cuda(  # noqa: E731
                xq, sx, qs[i], s, torch.bfloat16)
        else:
            run = lambda i: qm.quant_matmul_cuda(xb, qs[i], s, bits)  # noqa
        out[name] = device_ms(run, n_copy)
        del qs
    return out


def fused_call_ms(seed: int = 31):
    """Device ms of one K6 and one K7 call at BLOOM-7B1's decode shape
    (B = 8, D = 4096, 32 x 128, n_valid 576 of 640, bf16 x), a16 and a8,
    K7 through 16-slot pages of an arena of half the slab's pages; input
    sets (weights and cache) rotated through > 256 MB.  Inputs come from
    ``seed`` alone and go through the wrappers only, so a parent tree given
    the same arguments (``parent_decode_call_ms``) times the same work."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_arena import N_RESERVED
    B, D, nh, nkv, dh, W, nv = (ATTN7[k] for k in ("B", "D", "nh", "nkv",
                                                   "dh", "W", "n_valid"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bt = PAGED["bt"]
    n_b = W // bt
    P = N_RESERVED + math.ceil(B * n_b * PAGED["shrink"])
    table = torch.stack([N_RESERVED + torch.randperm(
        P - N_RESERVED, generator=gen, device=dev)[:n_b]
        for _ in range(B)]).to(torch.int32)
    x = torch.randn((B, D), generator=gen, device=dev).to(torch.bfloat16)
    ws = {a8: _fused_weights(D, nh, nkv, dh, gen, dev, 8 if a8 else 16)[0]
          for a8 in (False, True)}
    w_bytes = sum(w.numel() * w.element_size() for w in ws[False])
    n_copy = max(1, min(8, math.ceil(ROTATE_BYTES / (
        w_bytes + 2 * B * W * nkv * dh * 2))))
    wc = {a8: [[w.clone() for w in ws[a8]] for _ in range(n_copy)]
          for a8 in (False, True)}

    def kv(shape):
        return [torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(n_copy)]

    ks, vs = kv((B, W, nkv, dh)), kv((B, W, nkv, dh))
    kp, vp = kv((P, bt, nkv, dh)), kv((P, bt, nkv, dh))
    cos, sin = ops._rope_rows(nv, dh, 1e4, dev)
    out = {}
    for a8 in (False, True):
        tag = "_a8" if a8 else ""
        out["K6" + tag] = device_ms(
            lambda i: fd.flash_decode_fused_cuda(
                x, *wc[a8][i], ks[i], vs[i], nv, -1, cos, sin, True, a8),
            n_copy)
        out["K7" + tag] = device_ms(
            lambda i: fd.flash_decode_fused_paged_cuda(
                x, *wc[a8][i], kp[i], vp[i], table, nv, -1, cos, sin, True,
                a8), n_copy)
    return out


def parent_decode_call_ms(parent: Path):
    """``decode_call_ms`` of every quantized tier at BLOOM-3B's and at
    BLOOM-7B1's layer, and ``fused_call_ms`` (K6/K7), run by the checkout
    ``parent`` (its own kernels, built into ``parent/build``) in a process
    of its own on this card."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(parent / 'src')!r})\n"
        f"sys.path.insert(1, {str(ROOT)!r})\n"
        "import torch\n"
        "import chip_smoke as cs\n"
        "import repro_torch\n"
        "from repro_torch.kernels import _build\n"
        "_build.build_all()\n"
        "with torch.no_grad():\n"
        "    out = {t: cs.decode_call_ms(t) for t in ('w8a16', 'w8a8', 'w4a16')}\n"
        "    for t in ('w8a16', 'w8a8', 'w4a16'):\n"
        "        out[t + '_bloom7b1'] = cs.decode_call_ms(t, cs.LAYER_MATMULS_7B1)\n"
        "    out['fused'] = cs.fused_call_ms()\n"
        "out['tree'] = repro_torch.__file__\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900)
    check(r.returncode == 0, f"the parent tree {parent} failed:\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(out["tree"].startswith(str(parent.resolve())),
          f"the parent run imported {out['tree']}, not {parent}")
    log(f"parent tree {parent}: decode calls (ms) {json.dumps(out)}")
    return out


def quant_matmul_phase(tier: str, layer=LAYER_MATMULS,
                       phases=(("decode", DECODE_M), ("prefill", PREFILL_M))):
    """K1 (w8a16), K2 (w8a8) or K3 (w4a16) at one layer's shapes (BLOOM-3B's
    by default).  At prefill all three run a tensor-core kernel: its rows
    must not depend on M (rows of the M = 4096 call equal the same rows of
    M = 512 and M = 136 calls) and two calls must be bitwise equal; K2 is
    bitwise equal to its plain version at every phase, and at decode (the
    GEMV) its rows do not depend on M (each row of the M = 8 call equals
    the same row computed alone).  At decode each call of the layer is
    timed apart (``decode_call_ms``); K1 and K3 run their GEMV there
    (``qmm_a16_gemv``, counted by ``w8a16_gemv`` / ``w4a16_gemv``), with
    rows bitwise invariant in M and two calls bitwise equal, and their
    float32 x ``qmm_skinny``.  At prefill the CUDA-core tiled
    kernel is timed on the same work, and for K2 also the eager
    ``quantize_rowwise`` of its x (over copies of x that outsize the L2, as
    the weights are at decode)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.quant import ptq
    bits = 4 if tier == "w4a16" else 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err, f32_err = 0.0, 0.0
    acc = {phase: dict(ms=0.0, plain=0.0, lib_bf16=0.0, lib_int8=0.0,
                       tiled=0.0, qrow=0.0, nb=0.0, no=0.0)
           for phase, _ in phases}
    for K, N in sorted({(k, n) for _, k, n in layer}):
        count = sum(1 for _, k, n in layer if (k, n) == (K, N))
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
        for phase, M in phases:
            x = torch.randn((M, K), generator=gen, device=dev)
            xb = x.to(torch.bfloat16)
            tc = M > DECODE_M
            if tier == "w8a8":
                xq, sx = ptq.quantize_rowwise(xb)
                check(qm.route(M, K, N, torch.int8, 8)
                      == ("tc" if tc else "skinny"),
                      f"w8a8 M={M} K={K} N={N}: route "
                      f"{qm.route(M, K, N, torch.int8, 8)}")
                got = qm.quant_matmul_a8_cuda(xq, sx, q, s, torch.bfloat16)
                want = qm.quant_matmul_a8_plain(xq, sx, q, s, torch.bfloat16)
                check(torch.equal(got, want),
                      f"w8a8 M={M} K={K} N={N}: not bitwise equal to the "
                      f"plain version (max err {_max_err(got, want)})")
                if not tc:
                    for r in range(M):
                        check(torch.equal(got[r], qm.quant_matmul_a8_cuda(
                            xq[r:r + 1].contiguous(), sx[r:r + 1].contiguous(),
                            q, s, torch.bfloat16)[0]),
                              f"w8a8 GEMV K={K} N={N}: row {r} of M={M} != "
                              f"the same row at M=1")
                if tc:
                    for dt in (torch.float32, torch.bfloat16):
                        g = qm.quant_matmul_a8_cuda(xq, sx, q, s, dt)
                        check(torch.equal(g, qm.quant_matmul_a8_plain(
                            xq, sx, q, s, dt)) and torch.equal(
                                g, qm.quant_matmul_a8_cuda(xq, sx, q, s, dt)),
                              f"w8a8 tensor cores M={M} K={K} N={N} {dt}: "
                              f"not bitwise equal to the plain version, or "
                              f"two calls differ")
                    for m in (512, 136):
                        check(torch.equal(got[:m], qm.quant_matmul_a8_cuda(
                            xq[:m].contiguous(), sx[:m].contiguous(), q, s,
                            torch.bfloat16)),
                              f"w8a8 tensor cores K={K} N={N}: rows of "
                              f"M={M} != the same rows of M={m}")
                run = lambda i: qm.quant_matmul_a8_cuda(  # noqa: E731
                    xq, sx, qs[i], s, torch.bfloat16)
                plain = lambda i: qm.quant_matmul_a8_plain(  # noqa: E731
                    xq, sx, qs[i], s, torch.bfloat16)
                n_bytes = M * K + 4 * M + K * N + 4 * N + 2 * M * N
            else:
                check(qm.route(M, K, N, torch.bfloat16, bits)
                      == ("tc" if tc else "skinny"),
                      f"{tier} M={M} K={K} N={N}: route "
                      f"{qm.route(M, K, N, torch.bfloat16, bits)}")
                got = qm.quant_matmul_cuda(xb, q, s, bits)
                want = qm.quant_matmul_plain(xb, q, s, bits)
                _assert_close(got, want, BF16_TOL,
                              f"{tier} M={M} K={K} N={N} bf16")
                if tc:
                    check(torch.equal(got, qm.quant_matmul_cuda(xb, q, s,
                                                                bits)),
                          f"{tier} tensor cores M={M} K={K} N={N}: two "
                          f"calls differ")
                    for m in (512, 136):
                        check(torch.equal(got[:m], qm.quant_matmul_cuda(
                            xb[:m].contiguous(), q, s, bits)),
                              f"{tier} tensor cores K={K} N={N}: rows of "
                              f"M={M} != the same rows of M={m}")
                if phase == "decode":
                    ops.reset_launch_counts()
                    check(torch.equal(got, qm.quant_matmul_cuda(xb, q, s,
                                                                bits))
                          and ops.launch_counts()[tier + "_gemv"] == 1,
                          f"{tier} GEMV M={M} K={K} N={N}: two calls "
                          f"differ, or the call missed the GEMV "
                          f"({ops.launch_counts()})")
                    for r in range(M):
                        check(torch.equal(got[r], qm.quant_matmul_cuda(
                            xb[r:r + 1].contiguous(), q, s, bits)[0]),
                              f"{tier} GEMV K={K} N={N}: row {r} of M={M} "
                              f"!= the same row at M=1")
                    ops.reset_launch_counts()
                    g32 = qm.quant_matmul_cuda(x, q, s, bits)
                    check(ops.launch_counts()[tier + "_gemv"] == 0,
                          f"{tier} M={M} K={K} N={N}: float32 x took the "
                          f"GEMV")
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
            if tc:                            # decode: decode_call_ms
                a["ms"] += count * device_ms(run, n_rot)
            a["plain"] += count * device_ms(plain, n_rot)
            a["lib_bf16"] += count * device_ms(lib, n_rot_dense)
            if tc and tier == "w8a8":
                a["tiled"] += count * device_ms(
                    lambda i: _tiled_a8(xq, sx, qs[i], s))
                n_x = max(1, min(16, math.ceil(ROTATE_BYTES
                                               / (2 * xb.numel()))))
                xbs = [xb.clone() for _ in range(n_x)]
                a["qrow"] += count * device_ms(
                    lambda i: ptq.quantize_rowwise(xbs[i]), n_x)
                del xbs
            elif tc:
                a["tiled"] += count * device_ms(
                    lambda i: _tiled_a16(xb, qs[i], s, bits))
            else:
                a["tiled"] = None
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
        if phase == "decode":
            calls = decode_call_ms(tier, layer)
            a["ms"] = sum(calls.values())
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
        if phase == "decode":
            out[phase]["calls_ms"] = calls
        if a["lib_int8"] is not None:
            out[phase]["library_bf16_ms"] = a["lib_bf16"]
        if a["tiled"] is not None:
            # the same work on the CUDA-core tiled kernel it replaced
            out[phase]["cuda_core_tiled_ms"] = a["tiled"]
            if tier == "w8a8":
                # the W8A8 tier's eager activation quantization of the
                # layer's six inputs, outside the kernel
                out[phase]["quantize_rowwise_ms"] = a["qrow"]
    tol = ("bitwise; decode: rows of M=8 bitwise == the same rows at M=1"
           if tier == "w8a8" else
           f"bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}; "
           f"f32 rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g}); "
           f"decode on the GEMV: rows of M=8 bitwise == the same rows at "
           f"M=1, two calls bitwise equal") \
        + ("" if "prefill" not in acc else
           "; prefill on the tensor cores: rows of M=4096 bitwise == those "
           "of M=512 and M=136, two calls bitwise equal"
           + ("" if tier != "w8a8" else
              ", bf16 and f32 out"))
    return max_err, tol, out


def _split_edges(fd):
    """n_valid on each side of a split boundary of K4/K5."""
    return (fd.SPLIT - 1, fd.SPLIT, fd.SPLIT + 1)


def _rows_invariant(run, B, what):
    """``run(rows, wide)`` gives K4/K5's output for a subset of the rows,
    over the shape's window or a wider one (``wide``): each row must be
    the same bits alone, inside the batch, over the wider window and in a
    second call."""
    full = run(list(range(B)), False)
    check(torch.equal(full, run(list(range(B)), False)),
          f"{what}: two calls differ")
    check(torch.equal(full, run(list(range(B)), True)),
          f"{what}: rows change over a wider window")
    for r in range(B):
        check(torch.equal(run([r], False)[0], full[r]),
              f"{what}: row {r} alone != row {r} in the batch")


def flash_decode_phase(shape=ATTN, seed=2, scale=None, chain=None):
    """K4 at a decode shape: BLOOM-3B's (B=8, W=640, nh=nkv=32, dh=80) or
    BLOOM-7B1's (dh=128), its logits scaled by ``scale`` (None:
    1/sqrt(dh)).  The plain column times ``chain(q, k, v, n_valid)`` where
    given (the op chain a model ran before K4), else the plain version."""
    import functools
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    B, nh, nkv, dh, W, nv = (shape[k] for k in ("B", "nh", "nkv", "dh", "W",
                                                "n_valid"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err, f32_err = 0.0, 0.0
    q = torch.randn((B, nh, dh), generator=gen, device=dev)
    k = torch.randn((B, W, nkv, dh), generator=gen, device=dev)
    v = torch.randn((B, W, nkv, dh), generator=gen, device=dev)
    rows = torch.randint(1, W + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    for n_valid in (nv, W, 1, rows) + _split_edges(fd):
        g32 = fd.flash_decode_cuda(q, k, v, n_valid, scale)
        w32 = fd.flash_decode_plain(q, k, v, n_valid, scale)
        _assert_close(g32, w32, F32_TOL, "flash_decode f32")
        f32_err = max(f32_err, _max_err(g32, w32))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    for n_valid in (nv, W, rows) + _split_edges(fd):
        got = fd.flash_decode_cuda(qb, kb, vb, n_valid, scale)
        want = fd.flash_decode_plain(qb, kb, vb, n_valid, scale)
        _assert_close(got, want, BF16_TOL, "flash_decode bf16")
        max_err = max(max_err, _max_err(got, want))
    # rows: alone, in the batch, over a 1024-slot cache with other values
    # past W
    extra = [torch.randn((B, 1024 - W, nkv, dh), generator=gen, device=dev
                         ).to(torch.bfloat16) for _ in range(2)]
    kw, vw = (torch.cat([t, e], 1) for t, e in zip((kb, vb), extra))
    _rows_invariant(lambda r, wide: fd.flash_decode_cuda(
        qb[r], *((kw[r], vw[r]) if wide else (kb[r], vb[r])),
        rows[r].contiguous(), scale), B, f"flash_decode {nh} x {dh}")
    del kw, vw, extra
    n_copy = max(1, min(32, math.ceil(ROTATE_BYTES / (2 * kb.numel() * 2))))
    kvs = [(kb.clone(), vb.clone()) for _ in range(n_copy)]
    run = lambda i: fd.flash_decode_cuda(qb, *kvs[i], nv, scale)  # noqa: E731
    plain_fn = chain or functools.partial(fd.flash_decode_plain, scale=scale)
    plain = lambda i: plain_fn(qb, *kvs[i], nv)  # noqa: E731
    q4 = qb[:, :, None]                                  # (B, nh, 1, dh)
    lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q4, kvs[i][0][:, :nv].transpose(1, 2),
        kvs[i][1][:, :nv].transpose(1, 2), enable_gqa=nh != nkv,
        scale=scale)
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
           f"rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g}); "
           f"n_valid at split edges {_split_edges(fd)}; rows bitwise "
           f"invariant in B and W, two calls equal")
    return max_err, tol, out


def flash_decode_paged_phase(shape=ATTN, tail=PAGED["tail"], seed=3):
    """K5 at a decode shape through a block table: B=8, 40 blocks of 16
    slots (W=640), 32 heads of 80 (or 128), checked over an arena of 162
    pages that the rows share and timed over one of 322 pages, each row on
    pages of its own."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serving.kv_arena import N_RESERVED
    B, nh, nkv, dh, W, nv = (shape[k] for k in ("B", "nh", "nkv", "dh", "W",
                                                "n_valid"))
    bt = PAGED["bt"]
    n_b = W // bt
    P = N_RESERVED + math.ceil(B * n_b * PAGED["shrink"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
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
        for n_valid in (nv, W, 1, rows) + _split_edges(fd):
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
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    # rows: alone, in the batch, through a 64-block table (W = 1024) whose
    # blocks past W point at other pages
    more = N_RESERVED + torch.randint(0, P - N_RESERVED, (B, 64 - n_b),
                                      generator=gen, device=dev)
    table_w = torch.cat([table, more.to(torch.int32)], 1)
    _rows_invariant(lambda r, w: fd.flash_decode_paged_cuda(
        qb[r], kb, vb, (table_w if w else table)[r].contiguous(),
        rows[r].contiguous()), B, f"flash_decode_paged {nh} x {dh}")
    # a wider page tail, read through its leading corner in place
    wide = [torch.zeros((P, bt) + tail, dtype=torch.bfloat16,
                        device=dev) for _ in range(2)]
    wide[0][..., :nkv, :dh] = kb
    wide[1][..., :nkv, :dh] = vb
    kc, vc = (w[..., :nkv, :dh] for w in wide)
    check(not kc.is_contiguous(), "the corner view should be strided")
    got = fd.flash_decode_paged_cuda(qb, kc, vc, table, rows)
    _assert_close(got, fd.flash_decode_paged_plain(qb, kc, vc, table, rows),
                  BF16_TOL, f"flash_decode_paged on a {tail}-tail corner")
    check(torch.equal(got, fd.flash_decode_paged_cuda(qb, kb, vb, table,
                                                      rows)),
          "flash_decode_paged on a corner view != on the contiguous pages")
    # timing: arenas rotated through > 256 MB; k and v of one arena stacked
    # so that the yardstick gathers both in one call.  The main time reads
    # an arena where each row's blocks are pages of its own, as the
    # engine's leases are (B * n_b pages); shared_arena_ms reads the check
    # arena above, whose rows share pages (half of them, so part of the
    # reads hit the L2), the way this kernel was timed before.
    P2 = N_RESERVED + B * n_b
    own = (N_RESERVED + torch.randperm(B * n_b, generator=gen, device=dev)
           ).reshape(B, n_b).to(torch.int32)
    kv2 = torch.randn((2, P2, bt, nkv, dh), generator=gen, device=dev
                      ).to(torch.bfloat16)
    _assert_close(fd.flash_decode_paged_cuda(qb, kv2[0], kv2[1], own, rows),
                  fd.flash_decode_paged_plain(qb, kv2[0], kv2[1], own, rows),
                  BF16_TOL, "flash_decode_paged on pages of each row's own")

    def copies(kv):
        n = max(1, min(32, math.ceil(ROTATE_BYTES / (kv.numel() * 2))))
        return n, [kv.clone() for _ in range(n)]

    n_copy, kvs = copies(kv2)
    n_shared, shared = copies(torch.stack([kb, vb]))
    ol = own.long()
    run = lambda i: fd.flash_decode_paged_cuda(  # noqa: E731
        qb, kvs[i][0], kvs[i][1], own, nv)
    plain = lambda i: fd.flash_decode_paged_plain(  # noqa: E731
        qb, kvs[i][0], kvs[i][1], own, nv)
    q4 = qb[:, :, None]                                  # (B, nh, 1, dh)

    def lib(i):
        g = kvs[i][:, ol].reshape(2, B, W, nkv, dh)      # one gather
        return F.scaled_dot_product_attention(
            q4, g[0, :, :nv].transpose(1, 2), g[1, :, :nv].transpose(1, 2),
            enable_gqa=nh != nkv)

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
               bound_ms=b, bound_by=by, arena_pages=P2,
               shared_arena_ms=device_ms(lambda i: fd.flash_decode_paged_cuda(
                   qb, shared[i][0], shared[i][1], table, nv), n_shared),
               shared_arena_pages=P)
    tol = (f"bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}; f32 "
           f"rtol=atol={F32_TOL['rtol']} (max f32 err {f32_err:.3g}); "
           f"n_valid at split edges {_split_edges(fd)}; bitwise == "
           f"flash_decode on the gathered slab (f32 and bf16); rows bitwise "
           f"invariant in B and W, two calls equal; {tail}-tail corner read "
           f"in place")
    return max_err, tol, out


def _fused_weights(D, nh, nkv, dh, gen, dev, act_bits=16):
    """int8 wq, wk, wv, wo of one layer (from normal / sqrt(fan-in)) as
    the 8 kernel operands (int8, flat float32 scales), and the same
    weights dequantized to bf16 for the library composition."""
    from repro_torch.quant import ptq
    ops_, deq = [], []
    for shape in ((D, nh * dh), (D, nkv * dh), (D, nkv * dh), (nh * dh, D)):
        t = ptq.quantize(torch.randn(shape, generator=gen, device=dev)
                         / math.sqrt(shape[0]), 8, act_bits=act_bits)
        ops_ += [t.q, t.scale.reshape(-1)]
        deq.append(ptq.dequantize(ptq.QTensor(t.q, t.scale, 8, shape,
                                              torch.bfloat16)))
    return ops_, deq


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def fused_tolerances(dt, a8, ws, v_cache, want):
    """Tolerances of K6/K7 against their plain versions, for (o, k1, v1).

    k1 and v1 are rounded once from float32 sums taken in another order:
    the matmul tolerances (one bf16 ulp, or 1e-4 in float32).  o is the
    sum of nkv per-head partials, each rounded to x's type and added in
    that type head by head, as the TPU kernel accumulates: in bf16 a
    partial or a running sum a last bit apart moves an element by an ulp
    of the output's largest magnitude, so atol = 2^-6 * max|o|.  With a8
    the attention row (G * dh values) is quantized to int8 again on each
    side from float32 values that differ in their last bits: an element on
    a rounding boundary lands one step apart, which moves o by at most
    sx * max|wo|, with sx <= max|v| / 127 (attention is a convex
    combination of v); two such steps are allowed."""
    o_w, _, v1 = want
    flip = 0.0
    if a8:
        vmax = max(float(v_cache.abs().max()), float(v1.abs().max()))
        wo, so = ws[6], ws[7]
        flip = 2 * vmax / 127 * float((wo.abs().float() * so).max())
    if dt == torch.float32:
        kv, o = dict(F32_TOL), dict(rtol=1e-4, atol=1e-4 + flip)
    else:
        kv = dict(BF16_TOL)
        o = dict(rtol=2 ** -7,
                 atol=2 ** -6 * float(o_w.float().abs().max()) + flip)
    return o, kv, kv


def _fused_check(fn_cuda, fn_plain, x, ws, kv_args, pos, W, dh, a8, what):
    """One K6/K7 call against its plain version at position ``pos``;
    returns the kernel's (o, k1, v1) and the largest error."""
    from repro_torch.kernels import ops
    nv, ev = min(pos, W), (pos % W if pos >= W else -1)
    cos, sin = ops._rope_rows(pos, dh, 1e4, x.device)
    got = fn_cuda(x, *ws, *kv_args, nv, ev, cos, sin, True, a8)
    want = fn_plain(x, *ws, *kv_args, nv, ev, cos, sin, True, a8)
    tols = fused_tolerances(x.dtype, a8, ws, kv_args[1], want)
    err = 0.0
    for name, g, w, tol in zip(("o", "k1", "v1"), got, want, tols):
        _assert_close(g, w, tol, f"{what} pos={pos} a8={a8} {name}")
        err = max(err, _max_err(g, w))
    return got, err


def _fused_7b1_checks(x, kp, vp, table, ws):
    """At BLOOM-7B1's shape: K7 through the corner of a wider page tail in
    place, K6 at BLOOM-3B's 32 x 80 (D=2560), whose d_head the gate keeps
    off this tier, and K4/K5 at d_head 128 against their plain versions (K5
    bitwise == K4 on the gathered slab)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    B, D, nh, nkv, dh, W, nv = (ATTN7[k] for k in ("B", "D", "nh", "nkv",
                                                   "dh", "W", "n_valid"))
    dev, bt, P = x.device, kp.shape[1], kp.shape[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    tl = table.long()
    ks, vs = (p[tl].reshape((B, W) + tuple(p.shape[2:])) for p in (kp, vp))
    xb, kb, vb = (t.to(torch.bfloat16) for t in (x, kp, vp))
    # a wider page tail, read through its leading corner in place
    wide = [torch.zeros((P, bt) + TAIL7, dtype=torch.bfloat16, device=dev)
            for _ in range(2)]
    wide[0][..., :nkv, :dh] = kb
    wide[1][..., :nkv, :dh] = vb
    kc, vc = (w[..., :nkv, :dh] for w in wide)
    check(not kc.is_contiguous(), "the corner view should be strided")
    gc, _ = _fused_check(fd.flash_decode_fused_paged_cuda,
                         fd.flash_decode_fused_paged_plain, xb, ws,
                         (kc, vc, table), nv, W, dh, False,
                         f"flash_decode_fused_paged on a {TAIL7}-tail corner")
    cos, sin = ops._rope_rows(nv, dh, 1e4, dev)
    gp = fd.flash_decode_fused_paged_cuda(xb, *ws, kb, vb, table, nv, -1,
                                          cos, sin)
    check(all(torch.equal(a, b) for a, b in zip(gc, gp)),
          "flash_decode_fused_paged on a corner view != on the contiguous "
          "pages")
    # BLOOM-3B's geometry: the kernel takes d_head 80 (the gate does not)
    g3 = torch.Generator(device=dev).manual_seed(8)
    D3, dh3 = 2560, ATTN["dh"]
    x3 = torch.randn((B, D3), generator=g3, device=dev).to(torch.bfloat16)
    c3 = [torch.randn((B, W, nkv, dh3), generator=g3, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    for a8 in (False, True):
        ws3, _ = _fused_weights(D3, nh, nkv, dh3, g3, dev, 8 if a8 else 16)
        _fused_check(fd.flash_decode_fused_cuda, fd.flash_decode_fused_plain,
                     x3, ws3, c3, nv, W, dh3, a8,
                     "flash_decode_fused at 32 x 80")
    del ws3, c3
    # K4 and K5 at d_head 128 (BLOOM-7B1's W16A16 and W4A16 cohorts)
    q = torch.randn((B, nh, dh), generator=gen, device=dev)
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        qd, kd, vd, ksd, vsd = (t.to(dt) for t in (q, kp, vp, ks, vs))
        g4 = fd.flash_decode_cuda(qd, ksd, vsd, nv)
        _assert_close(g4, fd.flash_decode_plain(qd, ksd, vsd, nv), tol,
                      f"flash_decode {dt} at 32 x 128")
        g5 = fd.flash_decode_paged_cuda(qd, kd, vd, table, nv)
        _assert_close(g5, fd.flash_decode_paged_plain(qd, kd, vd, table, nv),
                      tol, f"flash_decode_paged {dt} at 32 x 128")
        check(torch.equal(g4, g5), f"flash_decode_paged {dt} at 32 x 128: "
              f"not bitwise equal to flash_decode on the gathered slab")
    log("fused phase at BLOOM-7B1's shape: K7 on a corner view, K6 at 32 "
        "x 80, K4/K5 at 32 x 128")


def fused_phase(shape=ATTN7, seed=7):
    """K6 and K7 at a decode shape, BLOOM-7B1's by default (B=8, W=640,
    n_valid 576, 32 x 128, D=4096, bf16, int8 weights), a16 and a8, each
    against its plain version (bf16, and float32), at positions 0 (no
    valid slot), 576, 640 (a full window) and 647 (the eviction slot); K7
    through a random permutation of 16-slot pages of an arena of half the
    slab's pages, bitwise equal to K6 on the gathered slab.  At BLOOM-7B1's
    shape also ``_fused_7b1_checks``.  Times K6 and K7 beside their bound,
    their plain versions and the library composition of the same function
    (SDPA with ``enable_gqa`` where G > 1)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_arena import N_RESERVED
    B, D, nh, nkv, dh, W, nv = (shape[k] for k in ("B", "D", "nh", "nkv",
                                                   "dh", "W", "n_valid"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bt = PAGED["bt"]
    n_b = W // bt
    P = N_RESERVED + math.ceil(B * n_b * PAGED["shrink"])
    table = torch.stack([N_RESERVED + torch.randperm(
        P - N_RESERVED, generator=gen, device=dev)[:n_b]
        for _ in range(B)]).to(torch.int32)
    tl = table.long()

    def gather(pages):
        return pages[tl].reshape((B, W) + tuple(pages.shape[2:]))

    x = torch.randn((B, D), generator=gen, device=dev)
    kp = torch.randn((P, bt, nkv, dh), generator=gen, device=dev)
    vp = torch.randn((P, bt, nkv, dh), generator=gen, device=dev)
    ks, vs = gather(kp), gather(vp)
    errs = {"K6": [0.0, 0.0], "K7": [0.0, 0.0]}        # [bf16, f32]
    wsets = {}
    for a8 in (False, True):
        ws, deq = _fused_weights(D, nh, nkv, dh, gen, dev, 8 if a8 else 16)
        wsets[a8] = (ws, deq)
        for dt, col in ((torch.bfloat16, 0), (torch.float32, 1)):
            xd, kd, vd, ksd, vsd = (t.to(dt) for t in (x, kp, vp, ks, vs))
            for pos in ((nv, 0, W, W + 7) if dt == torch.bfloat16
                        else (nv, W + 7)):
                g6, e6 = _fused_check(fd.flash_decode_fused_cuda,
                                      fd.flash_decode_fused_plain, xd, ws,
                                      (ksd, vsd), pos, W, dh, a8,
                                      f"flash_decode_fused {dt}")
                g7, e7 = _fused_check(fd.flash_decode_fused_paged_cuda,
                                      fd.flash_decode_fused_paged_plain, xd,
                                      ws, (kd, vd, table), pos, W, dh, a8,
                                      f"flash_decode_fused_paged {dt}")
                errs["K6"][col] = max(errs["K6"][col], e6)
                errs["K7"][col] = max(errs["K7"][col], e7)
                check(all(torch.equal(a, b) for a, b in zip(g7, g6)),
                      f"flash_decode_fused_paged {dt} pos={pos} a8={a8}: "
                      f"not bitwise equal to flash_decode_fused on the "
                      f"gathered slab")
    xb, kb, vb = (t.to(torch.bfloat16) for t in (x, kp, vp))
    if shape is ATTN7:
        _fused_7b1_checks(x, kp, vp, table, wsets[False][0])
    log(f"fused phase at {nh} x {dh} over {nkv} (D {D}, G {nh // nkv}, "
        f"cluster {fd.fused_plan(D, nkv, nh // nkv, dh).cluster}): K6/K7 "
        f"== plain (a16, a8; bf16, f32; pos 0, {nv}, {W}, {W + 7}), K7 == "
        f"K6 bitwise on the gathered slab")

    # timing: input sets (weights + cache or arena) rotated through > 256 MB
    deq = wsets[False][1]
    cache_bytes = 2 * B * W * nkv * dh * 2
    w_bytes = sum(w.numel() * w.element_size() for w in wsets[False][0])
    n_copy = max(1, min(8, math.ceil(ROTATE_BYTES / (w_bytes + cache_bytes))))
    wcopy = {a8: [[w.clone() for w in wsets[a8][0]] for _ in range(n_copy)]
             for a8 in (False, True)}
    caches = [(ks.to(torch.bfloat16), vs.to(torch.bfloat16),
               torch.stack([kb, vb])) for _ in range(n_copy)]
    deqs = [[w.clone() for w in deq] for _ in range(n_copy)]
    cos, sin = ops._rope_rows(nv, dh, 1e4, dev)
    half = dh // 2

    def rope(t):                                # (..., dh), bf16
        t1, t2 = t[..., :half].float(), t[..., half:].float()
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                         -1).to(t.dtype)

    def composition(i, k, v):
        """The same function from library calls: bf16 matmuls on the
        dequantized weights, rope, the cache write at slot nv, SDPA over
        the nv + 1 valid slots, the output matmul."""
        wq, wk, wv, wo = deqs[i]
        qh = rope((xb @ wq).reshape(B, nh, dh))
        k[:, nv] = rope((xb @ wk).reshape(B, nkv, dh))
        v[:, nv] = (xb @ wv).reshape(B, nkv, dh)
        att = F.scaled_dot_product_attention(
            qh[:, :, None], k[:, :nv + 1].transpose(1, 2),
            v[:, :nv + 1].transpose(1, 2), enable_gqa=nh != nkv)
        return att.reshape(B, nh * dh) @ wo

    def lib6(i):
        return composition(i, caches[i][0], caches[i][1])

    def lib7(i):
        g = caches[i][2][:, tl].reshape(2, B, W, nkv, dh)      # one gather
        return composition(i, g[0], g[1])

    def run6(i, a8=False):
        return fd.flash_decode_fused_cuda(
            xb, *wcopy[a8][i], caches[i][0], caches[i][1], nv, -1, cos, sin,
            True, a8)

    def run7(i, a8=False):
        return fd.flash_decode_fused_paged_cuda(
            xb, *wcopy[a8][i], caches[i][2][0], caches[i][2][1], table, nv,
            -1, cos, sin, True, a8)

    def plain6(i):
        return fd.flash_decode_fused_plain(
            xb, *wcopy[False][i], caches[i][0], caches[i][1], nv, -1, cos,
            sin)

    def plain7(i):
        return fd.flash_decode_fused_paged_plain(
            xb, *wcopy[False][i], caches[i][2][0], caches[i][2][1], table,
            nv, -1, cos, sin)

    # the composition computes the same function (on copies of the cache)
    ref = plain6(0)[0]
    for name, lib in (
            ("K6", lambda: composition(0, caches[0][0].clone(),
                                       caches[0][1].clone())),
            ("K7", lambda: lib7(0))):
        rel = _rel_err(lib(), ref)
        check(rel < LIBRARY_REL, f"{name} library composition disagrees "
              f"with the plain version: relative error {rel:.4g}")
    n_bytes = (2 * B * D + w_bytes + 2 * B * nv * nkv * dh * 2
               + 2 * B * D + 2 * 2 * B * nkv * dh)
    n_ops = 2.0 * B * D * (2 * nh * dh + 2 * nkv * dh) \
        + 4.0 * B * nh * (nv + 1) * dh
    out = {}
    for name, run, plain, lib, extra in (
            ("K6", run6, plain6, lib6, 0),
            ("K7", run7, plain7, lib7, 4 * B * n_b)):
        b, by = bound_ms(n_bytes + extra, n_ops, "int8")
        out[name] = dict(
            ms=device_ms(run, n_copy),
            a8_ms=device_ms(lambda i: run(i, True), n_copy),
            plain_ms=device_ms(plain, n_copy),
            library_ms=device_ms(lib, n_copy), bound_ms=b, bound_by=by,
            bound_bytes=n_bytes + extra, arena_pages=P,
            library_call=(
                "torch.matmul (bf16, dequantized q/k/v weights) + rope + "
                "cache write + torch.nn.functional.scaled_dot_product_"
                "attention + torch.matmul (wo), timed together"
                + ("" if name == "K6" else ", after a page gather "
                   "kv[:, table]")))
    tol = (f"k1, v1: bf16 rtol={BF16_TOL['rtol']} atol={BF16_TOL['atol']}, "
           f"f32 rtol=atol={F32_TOL['rtol']}; o: rtol as k1, atol bf16 "
           f"2^-6 max|o|, f32 1e-4, a8 plus two int8 steps of the "
           f"attention row (fused_tolerances)")
    return {name: (errs[name][0], tol + f" (max f32 err {errs[name][1]:.3g})"
                   + ("; bitwise == flash_decode_fused on the gathered slab "
                      "(f32 and bf16, a16 and a8)"
                      + (f"; {TAIL7}-tail corner read in place"
                         if shape is ATTN7 else "")
                      if name == "K7" else
                      f"; a16 and a8, pos 0/{nv}/{W}/{W + 7}"),
                   out[name]) for name in ("K6", "K7")}


def _ulp_err(got, want) -> float:
    """The largest |got - want| in bf16 ulps of the larger magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                             - 7)).max())


def add_norm_case(B, D, seed, kind="layernorm", add=True):
    """add_norm at one decode width (B rows of D, bf16) against its plain
    version (x_new bitwise, h within one bf16 ulp) and timed beside its
    bytes bound, the op chain and the library's ``x + y`` then
    ``F.layer_norm`` / ``F.rms_norm``; ``add`` False: the norm of x alone
    (no residual add, x_new is x)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_glue as dg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(torch.bfloat16)
    x = randn(B, 1, D)
    y = randn(B, 1, D, scale=2.0) if add else None
    w = (1 + randn(D, scale=0.1).float()).to(torch.bfloat16)
    got_x, got_h = dg.add_norm_cuda(x, y, w, kind)
    want_x, want_h = dg.add_norm_plain(x, y, w, kind)
    check(torch.equal(got_x, want_x), "add_norm: x_new is not bitwise x + y")
    err = _ulp_err(got_h, want_h)
    check(err <= 1.0, f"add_norm: h {err} bf16 ulps from the chain")

    def library(x, y):
        x = x if y is None else x + y
        if kind == "rmsnorm":
            return F.rms_norm(x, (D,), w, 1e-5)
        return F.layer_norm(x, (D,), w, None, 1e-5)
    _assert_close(library(want_x, None), want_h, LIBRARY_TOL,
                  f"F.{'rms' if kind == 'rmsnorm' else 'layer'}_norm "
                  f"yardstick")
    n_bytes = 2 * ((5 if add else 2) * B * D + D)  # x, y, w in; x_new, h out
    b, by = bound_ms(n_bytes, 8.0 * B * D, "bf16")
    return err, dict(
        ms=device_ms(lambda i: dg.add_norm_cuda(x, y, w, kind)),
        plain_ms=device_ms(lambda i: dg.add_norm_plain(x, y, w, kind)),
        library_ms=device_ms(lambda i: library(x, y)),
        library_call=("x + y, then " if add else "")
        + f"torch.nn.functional.{'rms' if kind == 'rmsnorm' else 'layer'}"
          f"_norm", bound_ms=b, bound_by=by,
        shape=f"add_norm B={B} D={D}, {kind}"
              + (" with the residual add" if add else ", no add") + ", bf16")


def rope_qk_write_case(shape, seed):
    """rope_qk_write at one decode shape (B rows, q, k of nh, nkv heads of
    dh rotated at a device position, k and v written into a slab of W
    slots, bf16) against its plain version (q and the written k within one
    bf16 ulp, v bitwise, no other slot touched; positions 0, 16, W - 1)
    and timed beside its bytes bound and the op chain."""
    from repro_torch.kernels import decode_glue as dg
    B, nh, nkv, dh, W = (shape[k] for k in ("B", "nh", "nkv", "dh", "W"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = randn(B, 1, nh, dh), randn(B, 1, nkv, dh), randn(B, 1, nkv, dh)
    ck, cv = randn(B, W, nkv, dh), randn(B, W, nkv, dh)
    freqs = dg.rope_table(dh, 1e4, dev)
    err = 0.0
    for p in (0, 16, W - 1):
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        gk, gv, wk, wv = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        gq = dg.rope_qk_write_cuda(q, k, v, pos, freqs, gk, gv)
        wq = dg.rope_qk_write_plain(
            q, k, v, pos.reshape(1, 1).expand(B, 1), wk, wv,
            torch.tensor([p], device=dev), 1e4)
        check(torch.equal(gv, wv), f"rope_qk_write: v at {p} not bitwise")
        check(torch.equal(torch.cat([gk[:, :p], gk[:, p + 1:]], 1),
                          torch.cat([ck[:, :p], ck[:, p + 1:]], 1)),
              f"rope_qk_write: a slot other than {p} changed")
        err = max(err, _ulp_err(gq, wq), _ulp_err(gk, wk))
    check(err <= 1.0, f"rope_qk_write: {err} bf16 ulps from the chain")
    pos = torch.tensor(W // 2, dtype=torch.int32, device=dev)
    positions = pos.reshape(1, 1).expand(B, 1)
    slot = torch.tensor([W // 2], device=dev)
    n_bytes = 2 * 2 * B * (nh + 2 * nkv) * dh + 4 * dh // 2
    b, by = bound_ms(n_bytes, 12.0 * B * (nh + nkv) * dh // 2, "bf16")
    return err, dict(
        ms=device_ms(lambda i: dg.rope_qk_write_cuda(q, k, v, pos, freqs,
                                                     ck, cv)),
        plain_ms=device_ms(lambda i: dg.rope_qk_write_plain(
            q, k, v, positions, ck, cv, slot, 1e4)),
        library_ms=None, library_call="none (no library rope)",
        bound_ms=b, bound_by=by,
        shape=f"rope_qk_write B={B}, {nh} x {dh} over {nkv}, W={W}, bf16")


ADD_NORM_TOL = "x_new bitwise; h within one bf16 ulp (in ulps)"
ROPE_TOL = ("q and k within one bf16 ulp (in ulps), v bitwise; positions "
            "0, 16, W - 1")


def decode_glue_phase(shape=ATTN, D=2560, seed=51):
    """The decode glue at one BLOOM model's decode widths (B = 8, bf16):
    add_norm (the residual add and a LayerNorm with its weight, D) and
    rope_qk_write, each against its plain version (the op chain it
    replaces) and timed.  The operands are the few kilobytes a decode
    step's GEMVs have just written: they are not rotated out of the L2."""
    err_n, norm = add_norm_case(shape["B"], D, seed)
    err_r, rope = rope_qk_write_case(shape, seed)
    return {"add_norm": (err_n, ADD_NORM_TOL, norm),
            "rope_qk_write": (err_r, ROPE_TOL, rope)}


def mamba2_decode_phase(seed=61):
    """``kops.mamba2_decode`` (``mamba2_scan_step`` + ``mamba2_gate_norm``)
    at Zamba2-7B-Instruct's decode layer (B = 8, 112 heads of 64, N 64,
    two groups, conv 4 with bias, bf16; random weights, state and input
    projection) against its plain version ``mamba2.decode_between`` (the
    op chain): the conv state bitwise, the SSM state within 1e-6, y within
    four bf16 ulps of its largest magnitude (the S C sum's order differs).
    Timed beside its bytes bound (``perfbench/costs/mamba2_decode.py``'s
    count) and the chain, each over enough states (29 MB each) to rotate
    them out of the L2; no library computes the step."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2
    cfg = get_arch("zamba2-7b-instruct")
    dt, dev, B = torch.bfloat16, "cuda", BATCH
    d_inner, H, P, N = mamba2.dims(cfg)
    G, K, C = cfg.ssm.n_groups, cfg.ssm.conv_width, mamba2.conv_channels(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = mamba2.init_block(cfg, gen, dt)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    p.update(conv_b=(0.1 * rnd(C)).to(dt), D=rnd(H),
             dt_bias=rnd(H) - 3.0, A_log=torch.log(1 + 15 * rnd(H).abs()),
             gate_norm=(1 + 0.1 * rnd(d_inner)).to(dt))
    proj = rnd(B, 1, d_inner + C + H).to(dt)
    state = {"ssm": 0.5 * rnd(B, H, P, N), "conv": rnd(B, K - 1, C).to(dt)}
    s1 = {k: v.clone() for k, v in state.items()}
    s2 = {k: v.clone() for k, v in state.items()}
    want = mamba2.decode_between(cfg, p, proj, s1)[:, 0]
    ops.reset_launch_counts()
    got = ops.mamba2_decode(proj[:, 0], s2["conv"], s2["ssm"], p, G)
    counts = ops.launch_counts()
    check(counts["mamba2_scan_step"] == counts["mamba2_gate_norm"] == 1,
          f"mamba2_decode: launches {counts}")
    check(torch.equal(s2["conv"], s1["conv"]),
          "mamba2_decode: conv state not bitwise the chain's")
    check(torch.allclose(s2["ssm"], s1["ssm"], rtol=1e-6, atol=1e-6),
          f"mamba2_decode: SSM state "
          f"{float((s2['ssm'] - s1['ssm']).abs().max()):.3g} from the chain")
    err = float((got.float() - want.float()).abs().max()) \
        / (2.0 ** -7 * float(want.float().abs().max()))
    check(err <= 4.0, f"mamba2_decode: y {err:.3g} bf16 ulps (of its "
          f"largest magnitude) from the chain")
    n_state = math.ceil(ROTATE_BYTES / (4 * B * H * P * N))
    states = [({k: v.clone() for k, v in state.items()},
               {k: v.clone() for k, v in state.items()})
              for _ in range(n_state)]
    d_inner_b = 2 * B * d_inner
    n_bytes = (8 * B * H * P * N + 2 * B * (d_inner + C + H)
               + 4 * B * (K - 1) * C + 2 * (K + 1) * C + 12 * H
               + 2 * d_inner + d_inner_b)
    b, by = bound_ms(n_bytes, 5.0 * B * H * P * N, "bf16")
    t = dict(ms=device_ms(lambda i: ops.mamba2_decode(
                 proj[:, 0], states[i][0]["conv"], states[i][0]["ssm"], p,
                 G), n_state),
             plain_ms=device_ms(lambda i: mamba2.decode_between(
                 cfg, p, proj, states[i][1]), n_state),
             library_ms=None, library_call="none (no library Mamba2 step)",
             bound_ms=b, bound_by=by)
    return err, ("conv state bitwise, SSM state within 1e-6, y within 4 "
                 "bf16 ulps of its largest magnitude (in those ulps)"), t


KERNELS = [
    # (name, counter, source, replaces, the main path whose run its
    # "launches" reports)
    ("quant_matmul_w8a16", "w8a16", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "dftsp_w8a16"),
    ("quant_matmul_w8a8", "w8a8", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97", "dftsp_auto_split"),
    ("quant_matmul_w4a16", "w4a16", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:79", "dftsp_w4a16"),
    # the tensor-core kernel (K1/K3 at prefill), at BLOOM-3B's and
    # BLOOM-7B1's prefill layer
    ("quant_matmul_w8a16_tc", "w8a16_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "dftsp_w8a16"),
    ("quant_matmul_w4a16_tc", "w4a16_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:79", "dftsp_w4a16"),
    ("quant_matmul_w8a16_tc_bloom7b1", "w8a16_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "bloom7b1_dftsp_w8a16"),
    ("quant_matmul_w4a16_tc_bloom7b1", "w4a16_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:79",
     "bloom7b1_continuous_auto_measured"),
    # the int8 tensor-core kernel (K2 at prefill); BLOOM-7B1's launches come
    # from the measured run, whose calibration runs every method
    ("quant_matmul_w8a8_tc", "w8a8_tc", "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97", "dftsp_auto_split"),
    ("quant_matmul_w8a8_tc_bloom7b1", "w8a8_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97",
     "bloom7b1_continuous_auto_measured"),
    # the GEMVs (K1/K3 with bf16 x, K2 at decode) at BLOOM-7B1's layer,
    # whose FFN runs them beside K6 (W4A16 beside K4/K5, in the measured
    # run's calibration); BLOOM-3B's are the decode halves of
    # quant_matmul_w8a16 / _w8a8 / _w4a16
    ("quant_matmul_w8a16_gemv_bloom7b1", "w8a16_gemv",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "bloom7b1_dftsp_w8a16"),
    ("quant_matmul_w4a16_gemv_bloom7b1", "w4a16_gemv",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:79",
     "bloom7b1_continuous_auto_measured"),
    ("quant_matmul_w8a8_gemv_bloom7b1", "w8a8_gemv",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97",
     "bloom7b1_continuous_auto_measured"),
    ("flash_decode", "flash_decode", "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:40", "dftsp_w8a16"),
    ("flash_decode_paged", "flash_decode_paged",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:403", "continuous_w8a16"),
    # K4/K5 at BLOOM-7B1's 32 x 128 (its W16A16 and W4A16 cohorts, which
    # the measured run's calibration and serving reach)
    ("flash_decode_bloom7b1", "flash_decode",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:40",
     "bloom7b1_continuous_auto_measured"),
    ("flash_decode_paged_bloom7b1", "flash_decode_paged",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:403",
     "bloom7b1_continuous_auto_measured"),
    ("flash_decode_fused", "flash_decode_fused",
     "src/repro_torch/csrc/flash_decode_fused.cu",
     "src/repro/kernels/flash_decode.py:182", "bloom7b1_dftsp_w8a16"),
    ("flash_decode_fused_paged", "flash_decode_fused_paged",
     "src/repro_torch/csrc/flash_decode_fused.cu",
     "src/repro/kernels/flash_decode.py:260", "bloom7b1_continuous_w8a16"),
    # the transformer family's other members: K1/K2 at granite's router
    # (N = 32) on the GEMVs at decode and the tensor cores at prefill
    ("quant_matmul_w8a16_gemv_router", "w8a16_gemv",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "granite_dftsp_w8a16"),
    ("quant_matmul_w8a16_tc_router", "w8a16_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:62", "granite_dftsp_w8a16"),
    ("quant_matmul_w8a8_gemv_router", "w8a8_gemv",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97", "granite_dftsp_auto_split"),
    ("quant_matmul_w8a8_tc_router", "w8a8_tc",
     "src/repro_torch/csrc/quant_matmul.cu",
     "src/repro/kernels/quant_matmul.py:97", "granite_dftsp_auto_split"),
    # K4/K5 at G = 2: qwen3's 16 x 128 and granite's 16 x 64 over 8
    ("flash_decode_qwen3", "flash_decode",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:40", "qwen3_dftsp_w8a16"),
    ("flash_decode_paged_qwen3", "flash_decode_paged",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:403", "qwen3_continuous_w8a16"),
    ("flash_decode_granite", "flash_decode",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:40", "granite_dftsp_w8a16"),
    # K6/K7 at G = 6 (internvl2, served) and G = 7 (deepseek-coder-33b's
    # shape, in the deepseek_coder_33b entry of the same row)
    ("flash_decode_fused_internvl2", "flash_decode_fused",
     "src/repro_torch/csrc/flash_decode_fused.cu",
     "src/repro/kernels/flash_decode.py:182", "internvl2_dftsp_w8a16"),
    ("flash_decode_fused_paged_internvl2", "flash_decode_fused_paged",
     "src/repro_torch/csrc/flash_decode_fused.cu",
     "src/repro/kernels/flash_decode.py:260", "internvl2_continuous_w8a16"),
    # the decode glue (no Pallas kernel: XLA fuses these chains in the JAX
    # package) at BLOOM-3B's and BLOOM-7B1's decode widths; BLOOM-7B1's
    # fused tier does its own rope, so its rope_qk_write launches come from
    # the measured run's K4/K5 cohorts
    ("decode_glue_add_norm", "add_norm", "src/repro_torch/csrc/decode_glue.cu",
     "src/repro/models/common.py:66", "dftsp_w8a16"),
    ("decode_glue_rope_qk_write", "rope_qk_write",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:96",
     "dftsp_w8a16"),
    ("decode_glue_add_norm_bloom7b1", "add_norm",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:66",
     "bloom7b1_dftsp_w8a16"),
    ("decode_glue_rope_qk_write_bloom7b1", "rope_qk_write",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:96",
     "bloom7b1_continuous_auto_measured"),
    # Zamba2-7B-Instruct's decode step: the glue at its widths (RMSNorm at
    # 3584 after a residual add, at 7168 over a site's concatenation; a
    # site's 32 x 224 rope and write) and the Mamba2 step between the
    # projections (no Pallas kernel: XLA runs the JAX package's chain)
    ("decode_glue_add_norm_zamba2", "add_norm",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:66",
     "zamba2i_dftsp_w8a16"),
    ("decode_glue_add_norm_zamba2_concat", "add_norm",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:66",
     "zamba2i_dftsp_w8a16"),
    ("decode_glue_rope_qk_write_zamba2", "rope_qk_write",
     "src/repro_torch/csrc/decode_glue.cu", "src/repro/models/common.py:96",
     "zamba2i_dftsp_w8a16"),
    ("mamba2_decode", "mamba2_scan_step",
     "src/repro_torch/csrc/mamba2_decode.cu",
     "src/repro/models/mamba2.py:203", "zamba2i_dftsp_w8a16"),
    # K4 at a site's 32 x 224 and scale: the JAX package's hybrid decodes
    # its attention with no kernel (gqa_attention)
    ("flash_decode_zamba2", "flash_decode",
     "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/models/common.py:345", "zamba2i_dftsp_w8a16"),
]


def ptxas_lines(source: str, kernel: str):
    """What ``nvcc -Xptxas -v`` said of each instantiation of ``kernel``
    (registers, barriers, stack, spills), one line each, from the build log
    of ``csrc/<source>.cu``."""
    from repro_torch.kernels import _build
    lines = (_build.build_dir() / f"{source}.log").read_text().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            name = line.split("'")[1]
            info = []
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "bytes stack frame" in nxt or "Used" in nxt:
                    info.append(nxt.split(":", 1)[-1].strip())
            out.append(f"{name}: {'; '.join(info)}")
    return out


def kernel_phase(parent=None):
    """Every kernel of KERNELS against its plain version, timed; with
    ``parent`` (a checkout of the parent commit), the quantized matmuls'
    decode calls are timed by that tree too, in this run on this card."""
    results, qmm, router = {}, {}, {}
    fused = fused_phase()
    torch.cuda.empty_cache()
    # K6/K7 at internvl2-26b's and deepseek-coder-33b's shapes (G = 6, 7)
    fused_gqa = {"internvl2": fused_phase(ATTN_INTERNVL2, 41),
                 "deepseek": fused_phase(ATTN_DEEPSEEK, 43)}
    torch.cuda.empty_cache()
    parent_ms = parent_decode_call_ms(parent) if parent else {}
    if parent_ms:
        # K6/K7 as the parent's calls time them, this tree's in the same way
        calls = fused_call_ms()
        torch.cuda.empty_cache()
        log(f"K6/K7 calls (ms): this tree {json.dumps(calls)}, the parent "
            f"{json.dumps(parent_ms['fused'])}")
        for k in ("K6", "K7"):
            for tag in ("", "_a8"):
                fused[k][2]["call" + tag + "_ms"] = calls[k + tag]
                fused[k][2]["parent" + tag + "_ms"] = parent_ms["fused"][k + tag]
    glue = {"": decode_glue_phase(),
            "_bloom7b1": decode_glue_phase(ATTN7, D=ATTN7["D"], seed=52)}
    zamba2 = zamba2_kernel_rows()
    for name, counter, *_ in KERNELS:
        if name in zamba2:
            err, tol, t = zamba2[name]
            shape = t.pop("shape")
        elif counter in ("add_norm", "rope_qk_write"):
            err, tol, t = glue["_bloom7b1" if name.endswith("_bloom7b1")
                               else ""][counter]
            shape = t.pop("shape")
        elif name.endswith("_router"):
            tier = counter.split("_")[0]
            if tier not in router:
                router[tier] = quant_matmul_phase(tier, ROUTER_MATMULS)
            err, tol, both = router[tier]
            regime = "decode" if "_gemv_" in name else "prefill"
            t = dict(both[regime])
            shape = (f"granite-moe-1b-a400m's router (K=1024, N=32), M="
                     f"{DECODE_M if regime == 'decode' else PREFILL_M} "
                     f"{regime} on the "
                     f"{'GEMV' if regime == 'decode' else 'tensor cores'}"
                     f", {_operands(counter)} (its weight, 32 KB, stays in "
                     f"the L2 across the rotated copies)")
        elif name.endswith("_internvl2"):
            k = "K6" if counter == "flash_decode_fused" else "K7"
            err, tol, t = fused_gqa["internvl2"][k]
            d_err, _, d_t = fused_gqa["deepseek"][k]
            t = dict(t, deepseek_coder_33b=dict(
                max_abs_err=d_err, **{f: d_t[f] for f in (
                    "ms", "a8_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}))
            a = ATTN_INTERNVL2
            shape = (f"one internvl2-26b layer's attention: B={a['B']} "
                     f"D={a['D']} nh={a['nh']} nkv={a['nkv']} dh={a['dh']} "
                     f"W={a['W']} n_valid={a['n_valid']}, bf16, int8 weights,"
                     f" a16 (a8_ms: W8A8); deepseek_coder_33b: the same at "
                     f"D=7168, 56 x 128 over 8")
        elif name.endswith("_gemv_bloom7b1"):
            tier = counter[:-len("_gemv")]
            err, tol, both = quant_matmul_phase(
                tier, LAYER_MATMULS_7B1, (("decode", DECODE_M),))
            t = dict(both["decode"])
            shape = (f"one BLOOM-7B1 decode layer on the "
                     f"{tier.upper()} GEMV: 4 x (K=N=4096) + (4096->16384) "
                     f"+ (16384->4096), M={DECODE_M}, {_operands(counter)}")
            if parent_ms:
                t["parent_calls_ms"] = parent_ms[tier + "_bloom7b1"]
        elif name.endswith("_tc_bloom7b1"):
            err, tol, both = quant_matmul_phase(
                counter[:-3], LAYER_MATMULS_7B1, (("prefill", PREFILL_M),))
            t = both["prefill"]
            shape = (f"one BLOOM-7B1 prefill layer on the tensor cores: 4 x "
                     f"(K=N=4096) + (4096->16384) + (16384->4096), "
                     f"M={PREFILL_M}, {_operands(counter)} (cuda_core_tiled_"
                     f"ms: the same work on the CUDA-core tiled kernel)")
        elif counter.endswith("_tc"):
            err, tol, both = qmm[counter[:-3]]
            t = both["prefill"]
            shape = (f"one BLOOM-3B prefill layer on the tensor cores: 4 x "
                     f"(K=N=2560) + (2560->10240) + (10240->2560), "
                     f"M={PREFILL_M}, {_operands(counter)} (cuda_core_tiled_"
                     f"ms: the same work on the CUDA-core tiled kernel)")
        elif counter in ("flash_decode_fused", "flash_decode_fused_paged"):
            err, tol, t = fused["K6" if counter == "flash_decode_fused"
                                else "K7"]
            shape = (f"one BLOOM-7B1 layer's attention: B={ATTN7['B']} "
                     f"D={ATTN7['D']} nh=nkv={ATTN7['nh']} dh={ATTN7['dh']} "
                     f"W={ATTN7['W']} n_valid={ATTN7['n_valid']}, bf16, int8 "
                     f"weights, a16 (a8_ms: W8A8)"
                     + ("" if counter == "flash_decode_fused" else
                        f", {ATTN7['W'] // PAGED['bt']} blocks of "
                        f"{PAGED['bt']} slots over {t['arena_pages']} pages"))
        elif counter == "flash_decode":
            family = FAMILY_ATTN.get(name.split("_")[-1])
            a, seed = family or ((ATTN7, 12) if name.endswith("_bloom7b1")
                                 else (ATTN, 2))
            err, tol, t = flash_decode_phase(a, seed)
            shape = (f"B={a['B']} W={a['W']} n_valid={a['n_valid']} "
                     f"nh={a['nh']} nkv={a['nkv']} dh={a['dh']} bf16, one "
                     f"call (one layer of a decode step)")
        elif counter == "flash_decode_paged":
            family = FAMILY_ATTN.get(name.split("_")[-1])
            a, tail, seed = ((family[0], PAGED["tail"], family[1] + 10)
                             if family else
                             (ATTN7, TAIL7, 13) if name.endswith("_bloom7b1")
                             else (ATTN, PAGED["tail"], 3))
            err, tol, t = flash_decode_paged_phase(a, tail, seed)
            shape = (f"B={a['B']} {a['W'] // PAGED['bt']} blocks of "
                     f"{PAGED['bt']} slots (W={a['W']}) n_valid="
                     f"{a['n_valid']} nh={a['nh']} nkv={a['nkv']} dh={a['dh']} "
                     f"bf16, each row on pages of its own ({t['arena_pages']}"
                     f" pages; shared_arena_ms: rows sharing "
                     f"{t['shared_arena_pages']} pages), one call (one "
                     f"layer of a decode step)")
        else:
            err, tol, both = qmm[counter] = quant_matmul_phase(counter)
            t = dict(both["decode"])
            if parent_ms:
                t["parent_calls_ms"] = parent_ms[counter]
            t.update({f"prefill_{k}": v for k, v in both["prefill"].items()})
            shape = (f"one BLOOM-3B layer: 4 x (K=N=2560) + (2560->10240) + "
                     f"(10240->2560), M={DECODE_M} decode "
                     f"(prefill_*: M={PREFILL_M}, tensor cores), "
                     f"{_operands(counter)}")
        if "parent_calls_ms" in t:
            t["parent_ms"] = sum(t["parent_calls_ms"].values())
        results[name] = dict(max_abs_err=err, tolerance=tol, shape=shape, **t)
        log(f"{name}: max_abs_err={err:.4g} ({tol}); ms={t['ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
            f"plain_ms={t['plain_ms']:.4f} library_ms="
            f"{'none' if t['library_ms'] is None else round(t['library_ms'], 4)}"
            + (f"; prefill ms={t['prefill_ms']:.3f} bound_ms="
               f"{t['prefill_bound_ms']:.3f} ({t['prefill_bound_by']}) "
               f"plain_ms={t['prefill_plain_ms']:.3f} library_ms="
               f"{t['prefill_library_ms']:.3f}" if "prefill_ms" in t else "")
            + (f"; a8 ms={t['a8_ms']:.4f}" if "a8_ms" in t else "")
            + (f"; parent ms={t['parent_ms']:.4f} a8 {t['parent_a8_ms']:.4f} "
               f"(this tree timed alike {t['call_ms']:.4f}, a8 "
               f"{t['call_a8_ms']:.4f})" if "parent_a8_ms" in t else "")
            + (f"; shared_arena_ms={t['shared_arena_ms']:.4f}"
               if "shared_arena_ms" in t else "")
            + (f"; cuda_core_tiled_ms={t['cuda_core_tiled_ms']:.3f}"
               if "cuda_core_tiled_ms" in t else "")
            + (f"; quantize_rowwise_ms={t['quantize_rowwise_ms']:.3f}"
               if "quantize_rowwise_ms" in t else "")
            + (f"; calls_ms={json.dumps(t['calls_ms'])}"
               if "calls_ms" in t else "")
            + (f"; parent_ms={t['parent_ms']:.4f} parent_calls_ms="
               f"{json.dumps(t['parent_calls_ms'])}"
               if "parent_calls_ms" in t else ""))
    return results


def zamba2_kernel_rows():
    """The rows of KERNELS at Zamba2-7B-Instruct's decode widths: (err,
    tolerance, timings with their "shape") by name."""
    Z = ATTN_ZAMBA2
    err_m, tol_m, t_m = mamba2_decode_phase()
    t_m["shape"] = ("one Zamba2-7B-Instruct Mamba2 layer's decode step "
                    "between its projections: B=8, 112 heads of 64, N=64, "
                    "2 groups, conv 4 with bias, bf16")
    rows = {"mamba2_decode": (err_m, tol_m, t_m)}
    for name, D, add, seed in (("decode_glue_add_norm_zamba2", Z["D"], True,
                                53),
                               ("decode_glue_add_norm_zamba2_concat",
                                2 * Z["D"], False, 54)):
        err, t = add_norm_case(Z["B"], D, seed, "rmsnorm", add)
        rows[name] = (err, ADD_NORM_TOL, t)
    err, t = rope_qk_write_case(Z, 55)
    rows["decode_glue_rope_qk_write_zamba2"] = (err, ROPE_TOL, t)
    err, tol, t = flash_decode_phase(Z, 56, ZAMBA2_SCALE, _site_chain)
    t["library_call"] += " (scale=(224/2)^-1/2)"
    t["shape"] = (f"one Zamba2-7B-Instruct site's attention: B={Z['B']} "
                  f"W={Z['W']} n_valid={Z['n_valid']} nh={Z['nh']} "
                  f"nkv={Z['nkv']} dh={Z['dh']} bf16, scale (dh/2)^-1/2; "
                  f"plain_ms: the op chain the site ran before K4 "
                  f"(gqa_attention: the mask, float32 copies of the whole "
                  f"slab, einsums)")
    rows["flash_decode_zamba2"] = (err, tol, t)
    return rows


def _site_chain(q, k, v, n_valid):
    """A Zamba2 site's decode attention as ``decode_attention_plain`` ran
    it: the validity mask, then ``gqa_attention``'s float32 copies of the
    whole slab, logits, softmax and the probabilities rounded to v's type
    before P @ V."""
    from repro_torch.models import common
    B, W = q.shape[0], k.shape[1]
    nv = torch.full((B,), n_valid, dtype=torch.int32, device=q.device)
    return common.gqa_attention(q[:, None], k, v,
                                common._valid_mask(nv, W),
                                ZAMBA2_SCALE)[:, 0]


def kernel_row(entry, runs, kernels):
    """The result row of one KERNELS entry: its kernel-phase numbers and
    its launches in each main path's run."""
    name, counter, source, replaces, path = entry
    launches = runs[path]["launches"]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[counter], launches_path=path,
        # the decode calls among them, on the tier's GEMV
        **({"gemv_launches": launches[counter + "_gemv"]}
           if counter in ("w8a16", "w4a16", "w8a8") else {}),
        # mamba2_decode's second kernel, launched once with each first
        **({"gate_norm_launches": launches["mamba2_gate_norm"]}
           if counter == "mamba2_scan_step" else {}),
        launches_by_path={label: run["launches"][counter]
                          for label, run in runs.items()},
        **kernels[name])


def _operands(counter: str) -> str:
    return ("int8 xq (quantize_rowwise of bf16 x) and weights, bf16 out"
            if counter.startswith("w8a8") else "bf16")


# ---------------------------------------------------------------------------
# Serving phases
# ---------------------------------------------------------------------------


def small_reference_phase(arch="bloom-3b", n_heads=4,
                          bits_list=(0, 8, (8, 8), 4), paged_bits=(8,),
                          tier="flash"):
    """Reduced float32 BLOOM: card (kernels) == CPU (plain versions); the
    kernels of ``tier`` launched for the int8 precisions."""
    from repro_torch import bridge
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena
    import numpy as np
    cfg = get_arch(arch).scaled(n_layers=2, d_model=256, n_heads=n_heads,
                                n_kv_heads=n_heads, d_ff=512, vocab=2048,
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
    slab, paged = ("flash_decode", "flash_decode_paged") if tier == "flash" \
        else ("flash_decode_fused", "flash_decode_fused_paged")
    for bits in bits_list:
        check(gpu.decode_tier(bits) == (tier if bits in (8, (8, 8))
                                        else "flash"),
              f"{arch} at bits={bits}: decode tier {gpu.decode_tier(bits)}")
        ops.reset_launch_counts()
        a = gpu.generate(prompts, caps, quant_bits=bits)
        if bits in (8, (8, 8)):
            check(ops.launch_counts()[slab] > 0,
                  f"reduced {arch} at bits={bits}: {slab} never launched")
        b = cpu.generate(prompts, caps, quant_bits=bits)
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.lengths, b.lengths),
              f"reduced float32 {arch} at bits={bits}: card tokens "
              f"{a.tokens.tolist()} != CPU tokens {b.tokens.tolist()}")
    for bits in paged_bits:
        ops.reset_launch_counts()
        a = gpu.generate_via_chunks(prompts, caps, k=5, quant_bits=bits,
                                    arena=KVArena.for_engines(gpu, 8))
        check(ops.launch_counts()[paged] > 0,
              f"reduced {arch} paged at bits={bits}: {paged} never launched")
        b = cpu.generate_via_chunks(prompts, caps, k=5, quant_bits=bits,
                                    arena=KVArena.for_engines(cpu, 8))
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.lengths, b.lengths),
              f"reduced float32 {arch}, paged at bits={bits}: card tokens "
              f"{a.tokens.tolist()} != CPU tokens {b.tokens.tolist()}")
    log(f"small reference: reduced float32 {arch} ({n_heads} heads of "
        f"{cfg.d_head}), card == CPU tokens at bits {list(bits_list)} "
        f"({tier} tier at 8 and (8, 8)), and paged (8-slot pages, k=5) at "
        f"bits {list(paged_bits)}")


def small_family_phase(archs=FAMILY_ARCHS, recurrent=RECURRENT_SMALL):
    """The transformer family's other members, each at the test suite's
    reduced shape (``launch.serve.reduced``: 2 layers, at most 4 experts,
    a window of 16) at float32, and qwen3 also at kv_bits=8; then the
    recurrent, hybrid and audio families (xlstm-1.3b at 9 layers: 7 mLSTM
    + 1 sLSTM + 1; zamba2-7b at 13: two shared-attention sites; whisper-tiny
    reduced), whose trees are dequantized at load and whose decode runs no
    kernel: the card must give the CPU's greedy tokens at every precision
    and move no kernel counter (tier "none").  Where no
    int8 rounding of a computed float sits between the two devices (bits
    0, 8 and 4 over a float KV cache), the card (kernels) must give the
    CPU's (plain versions) greedy tokens, slab and, where
    ``paged_capable``, paged.  W8A8 rounds every matmul's float32 input to
    int8 per row, and kv_bits=8 each token's k and v: a last-bit difference
    between the devices' float32 sums then moves a value a whole int8 step,
    which can part the greedy tokens at a near-tie (reduced
    mistral-large-123b at W8A8 does, on one row of four, on an H100).
    There the card must hold its own contracts bitwise
    (``generate == generate_reference``, paged == slab == ``generate``),
    and its tokens' agreement with the CPU's is reported.  The decode tier
    each takes (fused at W8 for d_head 128 without qk-norm, flash else, kv8
    with the int8 KV cache) must launch its slab kernel (none for kv8)."""
    from repro_torch import bridge
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import reduced
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena
    import numpy as np
    kw = dict(batch_capacity=4, s_max=32, n_max=16, quant_bits=8,
              use_kernel=True)
    cases = [(a, 16, {}) for a in archs] + [("qwen3-1.7b", 8, {})] \
        + [(a, 16, kw_) for a, kw_ in recurrent]
    kernel_counters = [c for c in ops.launch_counts() if c != "decode_loop"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (7, 32, 19, 3)]
    caps = [16, 9, 16, 4]

    def same(a, b):
        return np.array_equal(a.tokens, b.tokens) \
            and np.array_equal(a.lengths, b.lengths)

    out = {}
    for arch, kv_bits, over in cases:
        cfg = reduced(get_arch(arch)).scaled(dtype="float32", kv_bits=kv_bits,
                                             **over)
        cpu = ServingEngine(cfg, device="cpu", seed=6, **kw)
        gpu = ServingEngine(cfg, params=bridge.to_device(cpu._raw_params,
                                                         "cuda"),
                            device="cuda", **kw)
        label = arch + ("" if kv_bits == 16 else "_kv8")
        rec = out[label] = dict(tiers={}, paged=gpu.paged_capable,
                                rows_equal_to_cpu={})
        for bits in (0, 8, (8, 8), 4):
            tier = rec["tiers"][str(bits)] = gpu.decode_tier(bits)
            check(tier == cpu.decode_tier(bits), f"reduced {arch}: tiers "
                  f"differ between the card and the CPU")
            # the recurrent families' W8A8 tree is their dequantized W8A16
            # one: no int8 rounding of activations between the devices
            exact = kv_bits == 16 and (bits != (8, 8) or tier == "none")
            ops.reset_launch_counts()
            a = gpu.generate(prompts, caps, quant_bits=bits)
            counts = ops.launch_counts()
            slab = {"fused": "flash_decode_fused", "flash": "flash_decode",
                    "kv8": None, "none": None}[tier]
            check(slab is None or counts[slab] > 0,
                  f"reduced {arch} at bits={bits}: {slab} never launched")
            check(slab is not None or not any(counts[c] for c in (
                "flash_decode", "flash_decode_paged", "flash_decode_fused",
                "flash_decode_fused_paged")),
                  f"reduced {arch} kv8: a decode-attention kernel launched")
            check(tier != "none" or (not any(counts[c] for c in
                                             kernel_counters)
                                     and counts["decode_loop"] > 0),
                  f"reduced {arch} at bits={bits}: a kernel launched on a "
                  f"path that has none, or no device loop ({counts})")
            b = cpu.generate(prompts, caps, quant_bits=bits)
            rec["rows_equal_to_cpu"][str(bits)] = int(
                (a.tokens == b.tokens).all(1).sum())
            check(not exact or same(a, b),
                  f"reduced float32 {arch} at bits={bits}: card tokens "
                  f"{a.tokens.tolist()} != CPU tokens {b.tokens.tolist()}")
            if not exact:
                check(same(a, gpu.generate_reference(prompts, caps,
                                                     quant_bits=bits)),
                      f"reduced {label} at bits={bits}: generate != "
                      f"generate_reference on the card")
            if gpu.paged_capable and bits in (0, 8, (8, 8)):
                p = gpu.generate_via_chunks(prompts, caps, k=5,
                                            quant_bits=bits,
                                            arena=KVArena.for_engines(gpu, 8))
                want = cpu.generate_via_chunks(
                    prompts, caps, k=5, quant_bits=bits,
                    arena=KVArena.for_engines(cpu, 8)) if exact else a
                check(same(p, want),
                      f"reduced float32 {label}, paged at bits={bits}: card "
                      f"tokens != " + ("CPU tokens" if exact
                                       else "the card's slab tokens"))
        del cpu, gpu
    log(f"small reference: the transformer family at float32 (reduced): "
        f"card == CPU tokens at bits 0, 8 and 4 over a float KV cache, "
        f"slab and paged where paged-capable; at W8A8 and with the int8 KV "
        f"cache generate == generate_reference and paged == slab on the "
        f"card, rows equal to the CPU's reported; xlstm-1.3b, zamba2-7b and "
        f"whisper-tiny card == CPU tokens at every precision, no kernel "
        f"launched: {json.dumps(out)}")
    return out


class _W8A8Spans:
    """While active, CUDA events around each call of the W8A8 tier's
    activation quantization (``ops.quantize_rowwise``) and of K2
    (``quant_matmul_a8_cuda``).  ``external`` events are also recorded as
    nodes when the calls are captured into a CUDA graph."""

    def __init__(self, external: bool = False):
        self.external = external
        self.spans = {"quantize_rowwise": [], "kernel": []}

    def event(self):
        return torch.cuda.Event(enable_timing=True, external=self.external)

    def _timed(self, fn, key):
        def call(*args, **kw):
            ev = (self.event(), self.event())
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            self.spans[key].append(ev)
            return out
        return call

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import quant_matmul as qm
        self._saved = ops.quantize_rowwise, qm.quant_matmul_a8_cuda
        ops.quantize_rowwise = self._timed(self._saved[0], "quantize_rowwise")
        qm.quant_matmul_a8_cuda = self._timed(self._saved[1], "kernel")
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.kernels import quant_matmul as qm
        ops.quantize_rowwise, qm.quant_matmul_a8_cuda = self._saved

    def summary(self, total_ms: float, engine, what: str):
        out = {f"{what}_span_ms": total_ms}
        for key, evs in self.spans.items():
            ms = sum(a.elapsed_time(b) for a, b in evs)
            out.update({f"{key}_calls": len(evs), f"{key}_ms": ms,
                        f"{key}_share": ms / total_ms})
        check(out["kernel_calls"] > 0 and out["quantize_rowwise_calls"]
              == out["kernel_calls"],
              f"{engine.cfg.arch_id}: W8A8 {what} breakdown saw {out}")
        return out


def w8a8_prefill_breakdown(engine, params, tokens):
    """One W8A8 prefill with CUDA events around the whole call and around
    each call of its activation quantization (``ops.quantize_rowwise``) and
    of K2 (``quant_matmul_a8_cuda``): the time each takes inside the prefill
    itself.  An event pair spans what the stream ran between its two
    records, so a host gap inside a call would count too; the prefill's
    span is reported beside the sum."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _W8A8Spans() as sp:
        torch.cuda.synchronize()
        start.record()
        engine._prefill(params, tokens)
        end.record()
        torch.cuda.synchronize()
    total = start.elapsed_time(end)
    out = sp.summary(total, engine, "prefill")
    log(f"{engine.cfg.arch_id} W8A8 prefill (M={tokens.numel()}), timed in "
        f"place: span {total:.1f} ms; quantize_rowwise "
        f"{out['quantize_rowwise_ms']:.1f} ms over "
        f"{out['quantize_rowwise_calls']} calls (share "
        f"{out['quantize_rowwise_share']:.3f}); K2 {out['kernel_ms']:.1f} ms "
        f"over {out['kernel_calls']} calls (share {out['kernel_share']:.3f})")
    return out


def w8a8_decode_breakdown(engine, params, cache, cur):
    """One W8A8 decode step (the full batch at the first decode position),
    captured into a CUDA graph with CUDA events around the step and around
    each call of ``quantize_rowwise`` and of K2, and replayed: the device
    time of each inside the step's device work, with no host gap between
    the kernels (the eager step is host-bound), and its share.  The event
    nodes lengthen the graph, so the step's device time without them
    (``device_ms``) is reported beside the span."""
    step_ms = device_ms(lambda i: engine._decode(params, cache, cur, 0))
    graph = torch.cuda.CUDAGraph()
    with _W8A8Spans(external=True) as sp:
        start, end = sp.event(), sp.event()
        with torch.cuda.graph(graph):
            start.record()
            engine._decode(params, cache, cur, 0)
            end.record()
    graph.replay()
    torch.cuda.synchronize()
    total = start.elapsed_time(end)
    out = dict(sp.summary(total, engine, "step"), step_device_ms=step_ms)
    log(f"{engine.cfg.arch_id} W8A8 decode step (B={cur.shape[0]}), device "
        f"work timed in place: {total:.3f} ms with the events ({step_ms:.3f} "
        f"ms without); quantize_rowwise "
        f"{out['quantize_rowwise_ms']:.3f} ms over "
        f"{out['quantize_rowwise_calls']} calls (share "
        f"{out['quantize_rowwise_share']:.3f}); K2 {out['kernel_ms']:.3f} ms "
        f"over {out['kernel_calls']} calls (share {out['kernel_share']:.3f})")
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def eager_loop(engine):
    """While active, the engine's loop runs eagerly: its ``_advance_eager``,
    the loop the CPU runs (one ATen op after another), in place of the
    device loop, so that the two are timed in the same call."""
    engine._advance = engine._advance_eager
    try:
        yield
    finally:
        del engine._advance


def loop_timing(engine, prompts, bits, label, turns=1, arena=None,
                pre_ms=None, dev_ms=None):
    """``generate`` (with ``arena``: a paged cohort driven to its end by
    ``generate_via_chunks`` at k = n_max, which captures its loop anew)
    with the eager loop and with the device loop, in turns (eager first in
    even turns), after one replayed run that captures what it needs:
    each run's ms; ms per decode step past the prefill (``pre_ms``), over
    the steps each loop runs (the eager loop all min(n_max, max cap) of
    them, the device loop up to its early exit); the idle share of a step
    against its device time ``dev_ms``; the captures' ms.  Eager and
    replayed tokens must be equal."""
    import numpy as np
    caps = [engine.n_max] * len(prompts)

    def run():
        if arena is None:
            return engine.generate(prompts, caps, quant_bits=bits)
        return engine.generate_via_chunks(prompts, caps, k=engine.n_max,
                                          quant_bits=bits, arena=arena)

    n0 = len(engine.captures)
    want, first_ms = _timed(run)
    eager, replayed = [], []
    for turn in range(turns):
        for is_eager in ((True, False) if turn % 2 == 0 else (False, True)):
            if is_eager:
                with eager_loop(engine):
                    got, ms = _timed(run)
                eager.append(ms)
            else:
                got, ms = _timed(run)
                replayed.append(ms)
            check(np.array_equal(got.tokens, want.tokens)
                  and np.array_equal(got.lengths, want.lengths),
                  f"{label}: the eager and the device loop differ")
    captures = [c["ms"] for c in engine.captures[n0:]]
    steps = {"eager": min(engine.n_max, max(caps)),
             "replayed": int(want.lengths.max())}
    out = dict(eager_ms=eager, replayed_ms=replayed,
               first_replayed_ms=first_ms, capture_ms=captures,
               steps=steps)
    if pre_ms is not None:
        for name, runs in (("eager", eager), ("replayed", replayed)):
            per = (min(runs) - pre_ms) / steps[name]
            out[f"{name}_ms_per_step"] = per
            if dev_ms is not None:
                out[f"{name}_idle_share"] = 1.0 - dev_ms / per
    log(f"loop: {engine.cfg.arch_id} {label}: generate eager "
        f"{[round(x, 1) for x in eager]} ms, replayed "
        f"{[round(x, 1) for x in replayed]} ms (first replayed run "
        f"{first_ms:.1f} ms, captures {[round(c, 1) for c in captures]} "
        f"ms); steps {steps}"
        + (f"; per step eager {out['eager_ms_per_step']:.3f} ms, replayed "
           f"{out['replayed_ms_per_step']:.3f} ms" if pre_ms is not None
           else "")
        + (f"; idle share eager {out['eager_idle_share']:.3f}, replayed "
           f"{out['replayed_idle_share']:.3f} (device step {dev_ms:.3f} ms)"
           if pre_ms is not None and dev_ms is not None else ""))
    return out


def _kernel_events(prof):
    """(name, start us, end us) of every device kernel in a profile."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _kernel_summary(events, top: int):
    """Span, busy time (the union of the kernels' intervals), busy share
    and the ``top`` kernel names by summed time of ``_kernel_events``."""
    events = sorted(events, key=lambda e: e[1])
    busy, cur_s, cur_e = 0.0, events[0][1], events[0][2]
    for _, a, b in events[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = max(e[2] for e in events) - events[0][1]
    by_name = {}
    for name, a, b in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return dict(span_ms=span / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / span if span else None,
                top=[(name[:90], round(us / 1e3, 4), round(us / busy, 4))
                     for name, us in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:top]])


def trace_steps(engine, prompts, bits=8, top: int = 15):
    """One eager and one replayed decode step of a full cohort under
    ``torch.profiler``: the ``top`` device ops by summed time, the number
    of kernels, and the device busy share (the union of the kernels'
    intervals over the span from the first kernel's start to the last
    one's end).  With no device events in the trace, the step is timed by
    CUDA events instead, and no breakdown is given."""
    from torch.profiler import ProfilerActivity, profile
    st = engine.start_chunked(prompts, [engine.n_max] * len(prompts),
                              quant_bits=bits)
    st = engine.generate_chunked(st, 1)             # captures its loop
    engine.poll_chunked(st, with_tokens=False)
    out = {}
    for label in ("eager", "replayed"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            if label == "eager":
                with eager_loop(engine):
                    st = engine.generate_chunked(st, 1)
            else:
                st = engine.generate_chunked(st, 1)
            end.record()
            torch.cuda.synchronize()
        _, _, _, t = engine.poll_chunked(st, with_tokens=False)
        events = _kernel_events(prof)
        rec = dict(event_ms=start.elapsed_time(end), t=t,
                   kernels=len(events))
        if events:
            rec.update(_kernel_summary(events, top))
            log(f"trace: {engine.cfg.arch_id} {label} step: {len(events)} "
                f"kernels over {rec['span_ms']:.3f} ms, busy "
                f"{rec['busy_ms']:.3f} ms (busy share "
                f"{rec['busy_share']:.3f}); top {top} by time (name, ms, "
                f"share of busy): {rec['top']}")
        else:
            log(f"trace: {engine.cfg.arch_id} {label} step: key_averages() "
                f"show no device time; CUDA events: "
                f"{rec['event_ms']:.3f} ms")
        out[label] = rec
    return out


def early_eos_phase(engine, prompts, kw):
    """One cohort that stops early: ``eos_id`` is the token that
    ``generate_reference`` emits in row 0 at step 3, the other rows' caps
    are 16.  On an engine with that ``eos_id`` (the engine's weights),
    ``generate`` and a chunked cohort driven in one segment of n_max must
    give the oracle's tokens and lengths, and their device loops must run
    as many iterations as the oracle's loop (its longest row); the eager
    loop runs all n_max steps, so its time beside the device loop's is the
    cost of dead steps that the early exit saves."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    caps = [engine.n_max] + [16] * (len(prompts) - 1)
    eos = int(engine.generate_reference(prompts, caps).tokens[0, 3])
    eng = ServingEngine(engine.cfg, params=engine._raw_params, eos_id=eos,
                        quant_bits=8, **kw)
    ref = eng.generate_reference(prompts, caps)
    steps = int(ref.lengths.max())
    got, first_ms = _timed(lambda: eng.generate(prompts, caps))
    loop = eng._gen.graphs[8]
    check(np.array_equal(got.tokens, ref.tokens)
          and np.array_equal(got.lengths, ref.lengths),
          f"early EOS {eos}: generate != generate_reference")
    iters = loop.counted
    check(iters == int(loop.iters) == steps,
          f"early EOS: the device loop ran {iters} iterations, the "
          f"oracle's loop {steps}")
    _, replayed_ms = _timed(lambda: eng.generate(prompts, caps))
    with eager_loop(eng):
        _, eager_ms = _timed(lambda: eng.generate(prompts, caps))
    st = eng.generate_chunked(eng.start_chunked(prompts, caps), eng.n_max)
    out, lengths, done, t = eng.poll_chunked(st)
    check(t == steps and np.array_equal(out, ref.tokens)
          and np.array_equal(lengths, ref.lengths),
          f"early EOS: chunked t {t} != the oracle's {steps}, or tokens "
          f"differ")
    log(f"early EOS: eos_id {eos} (row 0's token at step 3), caps {caps}: "
        f"lengths {ref.lengths.tolist()}; generate_reference's loop ran "
        f"{steps} steps; the device loop ran {iters} iterations, "
        f"chunked t = {t}; generate {replayed_ms:.1f} ms replayed, "
        f"{eager_ms:.1f} ms eager (n_max = {eng.n_max} steps)")
    res = dict(eos_id=eos, steps=steps, lengths=ref.lengths.tolist(),
               loop_iterations=iters, replayed_ms=replayed_ms,
               eager_ms=eager_ms, chunked_t=t)
    del st, eng
    return res


# The main path, three ways: (label, the method the env deploys, policy
# spec, the engine's weight bits, counters that must launch in the run,
# counters that must not).  Each run is counted on its own.
MAIN_PATHS = [
    ("dftsp_w8a16", "W8A16", "dftsp", 8,
     ("w8a16", "w8a16_tc", "w8a16_gemv", "flash_decode", "decode_loop"),
     ("w8a8", "w8a8_tc", "w8a8_gemv", "w4a16", "w4a16_tc", "w4a16_gemv")),
    ("dftsp_auto_split", "W8A16", "dftsp:quant=auto,split=true", 8,
     ("w8a8", "w8a8_tc", "w8a8_gemv", "flash_decode", "decode_loop"), ()),
    ("dftsp_w4a16", "W4A16-GPTQ", "dftsp", 4,
     ("w4a16", "w4a16_tc", "w4a16_gemv", "flash_decode", "decode_loop"),
     ("w8a16", "w8a16_tc", "w8a16_gemv", "w8a8", "w8a8_tc", "w8a8_gemv")),
]


def check_prefill_on_tensor_cores(counts, label):
    """A run that served W8A16, W4A16 or W8A8 prefilled at M > 8, which the
    plan sends to a tensor-core kernel: its count must have moved.  At
    BLOOM's shapes (bf16, 16-byte loads) every other call is a decode call
    (M <= 8), and each of those must have run its tier's GEMV."""
    for c in ("w8a16", "w4a16", "w8a8"):
        if counts[c] > 0:
            check(counts[c + "_tc"] > 0,
                  f"{label}: {c} launched {counts[c]} times but never on "
                  f"the tensor cores (launches {counts})")
        check(counts[c + "_gemv"] == counts[c] - counts[c + "_tc"],
              f"{label}: {c} decode calls that missed the GEMV (launches "
              f"{counts})")


def epoch_path(engine, label, method, spec, launched, idle, rate: float,
               n_epochs: int):
    """One main path under ``EpochRuntime`` + ``EngineExecutor``, with the
    launch counters zeroed just before it and read just after."""
    from repro_torch.core.environment import paper_env
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.runtime import EngineExecutor, EpochRuntime
    runtime = EpochRuntime(paper_env(engine.cfg.arch_id, method),
                           get_policy(spec), EngineExecutor(engine, seed=0))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = runtime.run(rate=rate, n_epochs=n_epochs, seed=0, warmup_epochs=0)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    log(f"slice: {label}: {spec} deployed at {method} on a "
        f"{engine.cfg.arch_id} W{engine.default_bits} engine, {n_epochs} "
        f"epochs at rate {rate}: served={m.served} dropped={m.dropped} "
        f"truncated={m.truncated} tokens={m.generated_tokens} "
        f"batches={m.batch_sizes} methods={m.served_by_method} in "
        f"{run_ms:.0f} ms; launches {counts}")
    check(m.served > 0 and m.generated_tokens > 0,
          f"{label} served nothing: {m.served} requests, "
          f"{m.generated_tokens} tokens")
    for c in launched:
        check(counts[c] > 0, f"{label}: {c} was never launched "
              f"(launches {counts})")
    for c in idle:
        check(counts[c] == 0, f"{label}: {c} launched {counts[c]} "
              f"times on a path that does not serve it")
    check_prefill_on_tensor_cores(counts, label)
    return dict(served=m.served, dropped=m.dropped, truncated=m.truncated,
                tokens=m.generated_tokens, batches=m.batch_sizes,
                methods=m.served_by_method, run_ms=run_ms, launches=counts)


def serve_paths(engines, rate: float, n_epochs: int):
    """Each of BLOOM-3B's main paths (``MAIN_PATHS``), counted on its own."""
    return {label: epoch_path(engines[bits], label, method, spec, launched,
                              idle, rate, n_epochs)
            for label, method, spec, bits, launched, idle in MAIN_PATHS}


def continuous_phase(engine, spec: str = "dftsp",
                     launched=("flash_decode_paged", "w8a16", "w8a16_gemv",
                               "decode_loop"),
                     idle=("flash_decode",), rate: float = 10.0,
                     n_epochs: int = 3, k: int = 16, label="continuous",
                     policy=None):
    """``spec`` through ``ContinuousRuntime`` + ``EngineContinuousExecutor``
    over a paged arena of half the slab's pages, counted on its own: the
    counters in ``launched`` must move, those in ``idle`` must not (no
    slab decode kernel: every cohort is arena-backed)."""
    from repro_torch.core.environment import paper_env
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_arena import KVArena
    from repro_torch.serving.runtime import (ContinuousRuntime,
                                             EngineContinuousExecutor)
    arena = KVArena.for_engines(engine, block_tokens=PAGED["bt"],
                                shrink=PAGED["shrink"])
    runtime = ContinuousRuntime(
        paper_env(engine.cfg.arch_id, "W8A16"), policy or get_policy(spec),
        EngineContinuousExecutor(engine, seed=0, arena=arena), k=k)
    topups0 = engine.lease_topups
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = runtime.run(rate=rate, n_epochs=n_epochs, seed=0, warmup_epochs=0)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    log(f"{label}: {spec} on {engine.cfg.arch_id} over a {arena.n_pages}-"
        f"page arena ({PAGED['bt']}-slot pages, {PAGED['shrink']}x the "
        f"slab), k={k}, {n_epochs} epochs at rate {rate}: served={m.served} "
        f"dropped={m.dropped} shed={m.shed} tokens={m.generated_tokens} "
        f"mid-epoch admissions={m.admitted_mid_epoch} top-up pages="
        f"{m.kv_topup_pages} alloc_peak={arena.alloc_peak} mean block "
        f"occupancy={m.mean_block_occupancy:.4f} methods="
        f"{m.served_by_method} cohort methods by epoch="
        f"{[t.quants for t in m.traces]} in {run_ms:.0f} ms; launches "
        f"{counts}")
    check(m.served > 0 and m.generated_tokens > 0,
          f"{label} served nothing: {m.served} requests, "
          f"{m.generated_tokens} tokens")
    for c in launched:
        check(counts[c] > 0, f"{label}: {c} was never launched "
              f"(launches {counts})")
    for c in idle:
        check(counts[c] == 0, f"{label}: {c} launched {counts[c]} times "
              f"though every cohort is arena-backed")
    check_prefill_on_tensor_cores(counts, label)
    check(m.arrived == m.served + m.dropped + m.shed
          + len(m.final_queue_rids) + len(m.in_flight_rids),
          f"{label}: requests not conserved: arrived {m.arrived}, served "
          f"{m.served}, dropped {m.dropped}, shed {m.shed}, queued "
          f"{len(m.final_queue_rids)}, in flight {len(m.in_flight_rids)}")
    check(arena.free_pages == arena.total_pages,
          f"{label}: {arena.total_pages - arena.free_pages} pages still "
          f"leased after the drain")
    check(m.kv_topup_pages == engine.lease_topups - topups0,
          f"{label}: top-up pages disagree with the engine's count")
    return dict(served=m.served, dropped=m.dropped, shed=m.shed,
                tokens=m.generated_tokens,
                admitted_mid_epoch=m.admitted_mid_epoch,
                topup_pages=m.kv_topup_pages, alloc_peak=arena.alloc_peak,
                arena_pages=arena.n_pages,
                mean_block_occupancy=m.mean_block_occupancy,
                methods=m.served_by_method,
                cohort_methods=[t.quants for t in m.traces], run_ms=run_ms,
                launches=counts)


def paged_equivalence_phase(engine, prompts, caps, k: int = 16, bits=8,
                            step_timing: bool = True, loop_turns: int = 3):
    """Chunked decode over the arena, over the slab and ``generate`` give
    bitwise equal tokens at ``bits``; so do a paged and a slab cohort
    refilled at step 40.  For a VLM only the rows not refilled must agree
    there: its prompt pass fills cache slots from s_max on, which the slab
    keeps for a refilled row and the arena maps to the zero page, in the
    reference as here (F5, ``ROADMAP.md`` Queue 3).  Also times one paged
    decode step, eager and as a CUDA-graph replay, and a full paged cohort
    with the eager loop against the device loop (``loop_timing``,
    ``loop_turns`` turns)."""
    import numpy as np
    from repro_torch.serving.kv_arena import ZERO_PAGE, KVArena
    arena = KVArena.for_engines(engine, block_tokens=PAGED["bt"])
    what = f"{engine.cfg.arch_id} at bits={bits}"
    (g, s, p), ms = zip(*(_timed(fn) for fn in (
        lambda: engine.generate(prompts, caps, quant_bits=bits),
        lambda: engine.generate_via_chunks(prompts, caps, k=k,
                                           quant_bits=bits),
        lambda: engine.generate_via_chunks(prompts, caps, k=k,
                                           quant_bits=bits, arena=arena))))
    for name, r in (("slab", s), ("paged", p)):
        check(np.array_equal(r.tokens, g.tokens)
              and np.array_equal(r.lengths, g.lengths),
              f"generate_via_chunks ({name}, k={k}) != generate, {what}")
    half = len(prompts) // 2

    def refilled(arena):
        st = engine.start_chunked(prompts[:half], caps[:half],
                                  quant_bits=bits, arena=arena)
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
    rows = half if engine.cfg.family == "vlm" else len(prompts)
    check(np.array_equal(so[:rows], po[:rows])
          and np.array_equal(sl[:rows], pl[:rows]),
          f"paged cohort refilled at step 40 != slab cohort refilled at 40 "
          f"(rows below {rows}), {what}")
    check(arena.free_pages == arena.total_pages,
          "paged equivalence: pages still leased")
    check(all(not leaf[:, ZERO_PAGE].any()
              for leaf in arena.buffers().values()),
          "the zero page was written")
    log(f"paged == slab == generate, {what} ({len(prompts)} rows, k={k}): "
        f"generate {ms[0]:.0f} ms, chunked slab {ms[1]:.0f} ms, chunked "
        f"paged {ms[2]:.0f} ms; refilled at t=40 (rows {half}..): paged == "
        f"slab, lengths {pl.tolist()}"
        + ("" if rows == len(prompts) else
           f" (rows below {half} only, F5; refilled rows equal: "
           f"{int((so[half:] == po[half:]).all(1).sum())} of "
           f"{len(prompts) - half})"))
    out = dict(generate_ms=ms[0], chunked_slab_ms=ms[1],
               chunked_paged_ms=ms[2])
    if not step_timing:
        return out

    # one paged decode step of a full cohort at the mid position, eager and
    # with no host work between its kernels
    params = engine.params_for(bits)
    st = engine.start_chunked(prompts, [engine.n_max] * len(prompts),
                              quant_bits=bits, arena=arena)
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
    log(f"paged decode step, {what} (B={len(prompts)}, pos={pos}): "
        f"{step_ms:.2f} ms eager, {dev_ms:.2f} ms of device work (idle share "
        f"{1.0 - dev_ms / step_ms:.3f})")
    # a full paged cohort with the eager loop against the device loop, in
    # turns; its "prefill" is start_chunked (prefill and page scatter)
    full = [engine.n_max] * len(prompts)
    _, pre_ms = _timed(lambda: engine.release_all(engine.start_chunked(
        prompts, full, quant_bits=bits, arena=arena)))
    loop = loop_timing(engine, prompts, bits, f"paged {what}",
                       turns=loop_turns, arena=arena, pre_ms=pre_ms,
                       dev_ms=dev_ms)
    return dict(out, paged_step_ms=step_ms, paged_step_device_ms=dev_ms,
                paged_step_idle_share=1.0 - dev_ms / step_ms,
                paged_start_ms=pre_ms, loop=loop)


def slice_phase(cfg, device="cuda", batch=BATCH, s_max=S_MAX,
                n_max=N_MAX, rate: float = 10.0, n_epochs: int = 4):
    """Serve ``cfg`` through the main paths; returns what it measured."""
    from repro_torch.kernels import ops
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
    prompts, caps = _prompts(cfg, batch, s_max, n_max)
    for bits in (8, (8, 8), 4):
        _check_generate(engine, prompts, caps, bits)
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
        ops.reset_launch_counts()
        _, step_ms = _timed(steps)
        step_ms /= 8
        # a decode-only window: the quantized tier launches, the
        # tensor-core prefill kernel does not
        counts = ops.launch_counts()
        check(counts["w8a16_tc"] == counts["w4a16_tc"]
              == counts["w8a8_tc"] == 0
              and counts[{"W8A16": "w8a16", "W8A8": "w8a8", "W4A16": "w4a16",
                          "BF16": "flash_decode"}[label]] > 0
              and all(counts[c + "_gemv"] == counts[c]
                      for c in ("w8a16", "w4a16", "w8a8")),
              f"slice: {label}: decode-only window launched {counts}")
        # the same step with no host work between its kernels
        dev_ms = device_ms(lambda i: engine._decode(params, cache,
                                                           cur, 0))
        # generate with the eager loop against the device loop, in turns
        loop = loop_timing(engine, prompts, bits, label,
                           turns=3 if label == "W8A16" else 1,
                           pre_ms=pre_ms, dev_ms=dev_ms)
        gen_ms = min(loop["replayed_ms"])
        timings[label] = dict(prefill_ms=pre_ms, generate_ms=gen_ms,
                              decode_ms_per_step=step_ms,
                              decode_device_ms_per_step=dev_ms,
                              decode_idle_share=1.0 - dev_ms / step_ms,
                              loop=loop)
        if label == "W8A8":
            timings[label]["in_prefill"] = w8a8_prefill_breakdown(
                engine, params, tokens)
            timings[label]["in_decode"] = w8a8_decode_breakdown(
                engine, params, cache, cur)
        log(f"slice: {label}: prefill (M={batch * s_max}) {pre_ms:.1f} ms; "
            f"decode step {step_ms:.2f} ms eager, {dev_ms:.2f} ms of device "
            f"work (idle share {1.0 - dev_ms / step_ms:.3f}); generate of "
            f"{n_max} tokens x {batch} rows {gen_ms:.1f} ms replayed, "
            f"{min(loop['eager_ms']):.1f} ms eager")
        del cache
    # the step's device ops, eager and replayed, and an early-EOS cohort
    trace = trace_steps(engine, prompts, 8)
    early = early_eos_phase(engine, prompts, kw)

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
    return dict(runs=runs, timings=timings, unembed=unembed, paged=paged,
                kept_tables=kept_tables(engine), trace=trace,
                early_eos=early, captures=engine.captures)


def _prompts(cfg, batch, s_max, n_max, seed=0):
    """A full-length prompt with a full cap, and random others."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [s_max] + rng.integers(1, s_max + 1, size=batch - 1).tolist()
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
    caps = [n_max] + rng.integers(1, n_max + 1, size=batch - 1).tolist()
    return prompts, caps


def _check_generate(engine, prompts, caps, bits):
    """generate == generate_reference at ``bits``, tokens in range."""
    import numpy as np
    B, n_max, vocab = len(prompts), engine.n_max, engine.cfg.vocab
    a = engine.generate(prompts, caps, quant_bits=bits)
    b = engine.generate_reference(prompts, caps, quant_bits=bits)
    check(a.tokens.shape == (B, n_max)
          and ((a.tokens >= 0) & (a.tokens < vocab)).all()
          and (a.lengths >= 1).all()
          and (a.lengths <= np.minimum(caps, n_max)).all(),
          f"{engine.cfg.arch_id} bits={bits}: generated tokens out of range "
          f"or lengths {a.lengths} outside [1, caps]")
    check(np.array_equal(a.tokens, b.tokens)
          and np.array_equal(a.lengths, b.lengths),
          f"generate != generate_reference on full-width "
          f"{engine.cfg.arch_id} at bits={bits}")


class _OpCount:
    """Counts the ATen operations dispatched while active (views included):
    a host-side count of what an eager step asks of the device, beside the
    hand-written kernels' own counters (ctypes calls, not dispatched)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def decode_step_timing(engine, prompts, bits, label, unfused=False,
                       loop=False):
    """Prefill ms, then one decode step of the full batch: eager ms, device
    ms (its kernels replayed as one CUDA graph), the idle share, the
    hand-written kernel calls and the ATen ops it dispatches.  ``unfused``
    takes the step with the fused gate forced off (K1 projections + rope +
    K4, the tier the model would take without K6) for comparison.
    ``loop`` adds ``generate`` with the eager loop against the device
    loop (``loop_timing``)."""
    from repro_torch.kernels import ops
    params = engine.params_for(bits)
    host = engine._prepare(prompts, [engine.n_max] * len(prompts), bits)[1]
    tokens = host[:, :engine.s_max].to(engine.device)
    gate = ops.fusable_decode
    if unfused:
        ops.fusable_decode = lambda p, cfg: False
    try:
        engine._prefill(params, tokens)                   # warm
        (cur, cache), pre_ms = _timed(lambda: engine._prefill(params,
                                                              tokens))

        def steps(n=8):
            c = cur
            for t in range(n):
                c, _ = engine._decode(params, cache, c, t)

        steps(2)                                          # warm
        _, step_ms = _timed(steps)
        step_ms /= 8
        dev_ms = device_ms(lambda i: engine._decode(params, cache, cur, 0))
        ops.reset_launch_counts()
        with _OpCount() as n_ops:
            engine._decode(params, cache, cur, 0)
        calls = {k: v for k, v in ops.launch_counts().items() if v}
    finally:
        ops.fusable_decode = gate
    check(not calls.get("w8a16_tc") and not calls.get("w4a16_tc")
          and not calls.get("w8a8_tc"),
          f"{engine.cfg.arch_id} {label}: a decode step launched the "
          f"tensor-core prefill kernel: {calls}")
    counted = ops.launch_counts()          # a parent tree may lack a GEMV
    check(all(calls.get(c + "_gemv", 0) == calls.get(c, 0)
              for c in ("w8a16", "w4a16", "w8a8") if c + "_gemv" in counted)
          and (bits != (8, 8) or calls.get("w8a8_gemv", 0) > 0),
          f"{engine.cfg.arch_id} {label}: decode calls that missed their "
          f"GEMV: {calls}")
    out = dict(prefill_ms=pre_ms, decode_ms_per_step=step_ms,
               decode_device_ms_per_step=dev_ms,
               decode_idle_share=1.0 - dev_ms / step_ms,
               kernel_calls_per_step=calls, aten_ops_per_step=n_ops.n)
    # a VLM's prompt pass also holds its image positions
    n_img = engine.cfg.vlm.n_img_tokens if engine.cfg.family == "vlm" else 0
    if loop:
        out["loop"] = loop_timing(engine, prompts, bits, label, pre_ms=pre_ms,
                                  dev_ms=dev_ms)
    if bits == (8, 8) and not unfused:
        out["in_prefill"] = w8a8_prefill_breakdown(engine, params, tokens)
        out["in_decode"] = w8a8_decode_breakdown(engine, params, cache, cur)
    log(f"{engine.cfg.arch_id} {label}: prefill (M="
        f"{len(prompts) * (engine.s_max + n_img)}) {pre_ms:.1f} ms; decode "
        f"step {step_ms:.2f} ms eager, {dev_ms:.2f} ms of device work (idle "
        f"share {1.0 - dev_ms / step_ms:.3f}); per step: kernel calls "
        f"{calls}, "
        f"{n_ops.n} ATen ops dispatched")
    del cache
    return out


MEASURED_SPEC = "dftsp:quant=auto,split=true,calib=measured"


def continuous_measured_phase(engine, k: int = 16):
    """``dftsp:quant=auto,split=true,calib=measured`` through
    ``ContinuousRuntime`` over the arena: the runtime calibrates on the
    card at the start of the run (``measure_beta`` + ``attach_alphas`` +
    ``measured_methods``, then ``measure_swap_cost``) and serves on the
    measured coefficients.  The measured records are read as the runtime
    makes them, and the counters snapshotted when calibration ends, so the
    launches of calibration and of serving are reported apart."""
    from repro_torch.core.policy import get_policy
    from repro_torch.core.quantization import METHODS
    from repro_torch.kernels import ops
    from repro_torch.quant import calibration
    seen = {}
    policy = get_policy(MEASURED_SPEC)
    measure_beta, install_swap = calibration.measure_beta, \
        policy.install_swap_costs

    def recording_beta(*args, **kw):
        seen["t0"] = time.perf_counter()
        seen["beta"] = measure_beta(*args, **kw)     # alphas attached later
        return seen["beta"]

    def recording_swap(record):
        torch.cuda.synchronize()
        seen["calibration_s"] = time.perf_counter() - seen["t0"]
        seen["calibration_launches"] = ops.launch_counts()
        seen["swap"] = record
        install_swap(record)

    calibration.measure_beta = recording_beta
    policy.install_swap_costs = recording_swap
    try:
        run = continuous_phase(engine, MEASURED_SPEC, launched=(), idle=(),
                               k=k, label="bloom7b1_continuous_auto_measured",
                               policy=policy)
    finally:
        calibration.measure_beta = measure_beta
    beta, swap = seen["beta"], seen["swap"]
    cal = seen["calibration_launches"]
    serving = {c: run["launches"][c] - cal[c] for c in cal}
    check(beta["backend"] == swap["backend"] == engine.device.type,
          f"calibration did not run on the engine's device: "
          f"{beta['backend']}, {swap['backend']}")
    check(set(beta["methods"]) == set(METHODS)
          and all(m["beta"] > 0 for m in beta["methods"].values()),
          f"measured betas incomplete: {beta['methods']}")
    check(all(0 < beta["methods"][n]["alpha_w"] < 1 for n in METHODS
              if METHODS[n].weight_bits < 16), "measured alphas missing")
    check(len(swap["pairs"]) == 12, f"swap pairs: {sorted(swap['pairs'])}")
    for c in ("flash_decode_fused", "w8a16", "w8a8", "w4a16",
              "flash_decode", "w8a16_tc", "w4a16_tc", "w8a8_tc",
              "w8a16_gemv", "w4a16_gemv", "w8a8_gemv"):
        check(cal[c] > 0, f"calibration: {c} was never launched ({cal})")
    check_prefill_on_tensor_cores(serving, "measured serving")
    check(serving["flash_decode"] == serving["flash_decode_fused"] == 0,
          f"serving over the arena launched a slab decode kernel: {serving}")
    check(serving["decode_loop"] > 0,
          f"measured serving ran no device loop: {serving}")
    # the methods served: each epoch's cohort method, and each request's
    # own (a split cohort serves some rows at its second method)
    served = {q for t in run["cohort_methods"] for q in t.values()} \
        | set(run["methods"])
    int8 = any(q in ("W8A16", "W8A8") for q in served)
    other = any(q not in ("W8A16", "W8A8") for q in served)
    check((serving["flash_decode_fused_paged"] > 0) == int8
          and (serving["flash_decode_paged"] > 0) == other,
          f"serving launches {serving} do not follow the methods served: "
          f"cohorts {run['cohort_methods']}, requests {run['methods']}")
    snapped = policy._measured
    log(f"calibration on {beta['arch']} ({beta['backend']}, "
        f"{seen['calibration_s']:.1f} s): "
        + "; ".join(
            f"{n}: beta {m['beta']:.4f} (snapped {snapped[n].beta}) per "
            f"batch {m['per_batch']} tok/s {m['tok_s']} fp tok/s "
            f"{m['tok_s_fp']}"
            + (f" alpha_w {m['alpha_w']:.4f}" if "alpha_w" in m else "")
            for n, m in beta["methods"].items())
        + f"; swap pairs (s) "
        f"{ {p: round(v['swap_s'], 6) for p, v in swap['pairs'].items()} } "
        f"default_s {swap['default_s']:.6f}; launches in calibration "
        f"{cal}, in serving {serving}")
    return dict(run, calibration_s=seen["calibration_s"],
                calibration_launches=cal, serving_launches=serving,
                beta_record=beta, swap_record=swap,
                snapped_betas={n: m.beta for n, m in snapped.items()})


def slice_7b1_phase(cfg, device="cuda", batch=BATCH, s_max=S_MAX,
                    n_max=N_MAX, rate: float = 10.0, n_epochs: int = 2):
    """Full-width BLOOM-7B1 on the fused tier: the epoch path at W8A16
    (K6), the continuous path at W8A16 over the arena (K7), the continuous
    path with measured calibration, generate == generate_reference and
    paged == slab == generate at W8A16 and W8A8, and the decode step."""
    from repro_torch.serving.engine import ServingEngine
    kw = dict(batch_capacity=batch, s_max=s_max, n_max=n_max, device=device)
    engine, init_ms = _timed(lambda: ServingEngine(cfg, quant_bits=8, seed=0,
                                                   **kw))
    log(f"slice: {cfg.arch_id} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, vocab "
        f"{cfg.vocab}, {cfg.dtype}) built and quantized to W8 in "
        f"{init_ms:.0f} ms")
    for bits, tier in ((8, "fused"), ((8, 8), "fused"), (0, "flash"),
                       (4, "flash")):
        check(engine.decode_tier(bits) == tier,
              f"{cfg.arch_id} at bits={bits}: decode tier "
              f"{engine.decode_tier(bits)}, expected {tier}")
    slab_decode = ("flash_decode", "flash_decode_paged")
    runs = {"bloom7b1_dftsp_w8a16": epoch_path(
        engine, "bloom7b1_dftsp_w8a16", "W8A16", "dftsp",
        ("flash_decode_fused", "w8a16", "w8a16_tc", "w8a16_gemv",
         "decode_loop"),
        slab_decode + ("flash_decode_fused_paged", "w8a8", "w8a8_tc",
                       "w8a8_gemv", "w4a16", "w4a16_tc", "w4a16_gemv"), rate,
        n_epochs)}
    prompts, caps = _prompts(cfg, batch, s_max, n_max)
    for bits in (8, (8, 8)):
        _check_generate(engine, prompts, caps, bits)
    log(f"slice: {cfg.arch_id}: generate == generate_reference at W8A16 and "
        f"W8A8 ({batch} rows, {n_max} tokens)")
    runs["bloom7b1_continuous_w8a16"] = continuous_phase(
        engine, launched=("flash_decode_fused_paged", "w8a16", "w8a16_tc",
                          "w8a16_gemv", "decode_loop"),
        idle=slab_decode + ("flash_decode_fused",),
        label="bloom7b1_continuous_w8a16")
    runs["bloom7b1_continuous_auto_measured"] = \
        continuous_measured_phase(engine)
    paged = {str(bits): paged_equivalence_phase(
        engine, prompts, caps, bits=bits, step_timing=bits == 8,
        loop_turns=1)
        for bits in (8, (8, 8))}
    timings = {label: decode_step_timing(engine, prompts, bits, label,
                                         unfused=unfused,
                                         loop=label in ("W8A16", "W8A8"))
               for label, bits, unfused in (
                   ("W8A16", 8, False), ("W8A16 unfused", 8, True),
                   ("W8A8", (8, 8), False), ("BF16", 0, False))}
    return dict(runs=runs, timings=timings, paged=paged,
                kept_tables=kept_tables(engine), captures=engine.captures)


# The transformer family's other members at full width and depth.  Every
# attention kernel and every quantized tier the others do not serve.
ATTN_COUNTERS = ("flash_decode", "flash_decode_paged", "flash_decode_fused",
                 "flash_decode_fused_paged")
W8A16_ONLY = ("w8a8", "w8a8_tc", "w8a8_gemv", "w4a16", "w4a16_tc",
              "w4a16_gemv")


def _free():
    """Return the memory of engines that went out of scope to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _family_engine(cfg, what, **kw):
    """A W8 engine of ``cfg`` at B = 8, s' = 512, n_max = 128 with random
    weights from seed 0 (``kw``: params of another engine to share)."""
    from repro_torch.serving.engine import ServingEngine
    engine, init_ms = _timed(lambda: ServingEngine(
        cfg, quant_bits=8, seed=0, batch_capacity=BATCH, s_max=S_MAX,
        n_max=N_MAX, device="cuda", **kw))
    log(f"slice: {cfg.arch_id}{what} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head} over "
        f"{cfg.n_kv_heads}, vocab {cfg.vocab}, {cfg.dtype}"
        + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
           if cfg.is_moe else "")
        + (f", kv_bits {cfg.kv_bits}" if cfg.kv_bits != 16 else "")
        + f") built and quantized to W8 in {init_ms:.0f} ms")
    return engine


def qwen3_phase(cfg, n_epochs: int = 2):
    """qwen3-1.7b (28 layers, qk-norm, 16 heads of 128 over 8, tied vocab
    151,936): ``dftsp`` epochs at W8A16 (K1 and K4; qk-norm keeps it off
    the fused tier, so K6 must not launch) and continuously over an arena
    of half the slab's pages (K5); then a kv_bits=8 engine on the same
    weights, as epochs and continuously over an arena with scale pages,
    where no decode-attention kernel launches (tier "kv8").  On both:
    ``generate == generate_reference`` at W8A16 and W8A8, paged == slab ==
    ``generate``, and the decode step's times; one kv8 step traced."""
    prompts, caps = _prompts(cfg, BATCH, S_MAX, N_MAX)
    out = dict(runs={}, timings={}, paged={})
    engine = _family_engine(cfg, "")
    check(engine.decode_tier(8) == engine.decode_tier((8, 8)) == "flash",
          f"qwen3: decode tier {engine.decode_tier(8)}")
    kv8 = _family_engine(cfg.scaled(kv_bits=8), " (int8 KV cache)",
                         params=engine._raw_params)
    check(kv8.decode_tier(8) == kv8.decode_tier((8, 8)) == "kv8",
          f"qwen3 kv8: decode tier {kv8.decode_tier(8)}")
    for eng, tag, launched, idle, cont_launched in (
            (engine, "", ("flash_decode",),
             ("flash_decode_fused", "flash_decode_fused_paged",
              "flash_decode_paged"), ("flash_decode_paged",)),
            (kv8, "_kv8", (), ATTN_COUNTERS, ())):
        out["runs"][f"qwen3{tag}_dftsp_w8a16"] = epoch_path(
            eng, f"qwen3{tag}_dftsp_w8a16", "W8A16", "dftsp",
            launched + ("w8a16", "w8a16_tc", "w8a16_gemv", "decode_loop"),
            idle + W8A16_ONLY, 10.0, n_epochs)
        for bits in (8, (8, 8)):
            _check_generate(eng, prompts, caps, bits)
        out["runs"][f"qwen3{tag}_continuous_w8a16"] = continuous_phase(
            eng, launched=cont_launched + ("w8a16", "w8a16_gemv",
                                           "decode_loop"),
            idle=ATTN_COUNTERS if tag else ("flash_decode",
                                            "flash_decode_fused",
                                            "flash_decode_fused_paged"),
            label=f"qwen3{tag}_continuous_w8a16")
        if tag:
            from repro_torch.serving.kv_arena import KVArena
            leaves = sorted(KVArena.for_engines(eng, PAGED["bt"]).buffers())
            check(leaves == ["k", "ks", "v", "vs"],
                  f"qwen3 kv8 arena leaves {leaves}")
        out["paged"][tag or "fp"] = paged_equivalence_phase(
            eng, prompts, caps, bits=8, step_timing=False)
        out["timings"][f"W8A16{tag}"] = decode_step_timing(
            eng, prompts, 8, f"W8A16{tag}", loop=True)
        if tag:
            out["trace_kv8"] = trace_steps(eng, prompts, 8)
    log(f"slice: qwen3-1.7b: generate == generate_reference at W8A16 and "
        f"W8A8, paged == slab == generate, with the fp and the int8 KV cache")
    out["captures"] = engine.captures + kv8.captures
    return out


def granite_phase(cfg, n_epochs: int = 2):
    """granite-moe-1b-a400m (24 layers, 32 experts top-8, 16 heads of 64
    over 8, tied vocab 49,155), slab only (MoE is not paged-capable):
    ``dftsp`` epochs at W8A16 and ``dftsp:quant=auto,split=true`` epochs
    (the router's decode calls on its W8A8 epochs count as ``w8a8_gemv``);
    ``generate == generate_reference`` at each precision; two replays of
    one captured MoE step from the same state give bitwise equal tokens;
    chunked == ``generate``; the decode step's times, and one step
    traced."""
    import numpy as np
    prompts, caps = _prompts(cfg, BATCH, S_MAX, N_MAX)
    engine = _family_engine(cfg, "")
    check(not engine.paged_capable and engine.decode_tier(8) == "flash",
          "granite: expected a slab-only engine on the unfused tier")
    runs = {"granite_dftsp_w8a16": epoch_path(
        engine, "granite_dftsp_w8a16", "W8A16", "dftsp",
        ("w8a16", "w8a16_tc", "w8a16_gemv", "flash_decode", "decode_loop"),
        ATTN_COUNTERS[1:] + W8A16_ONLY, 10.0, n_epochs)}
    runs["granite_dftsp_auto_split"] = epoch_path(
        engine, "granite_dftsp_auto_split", "W8A16",
        "dftsp:quant=auto,split=true",
        ("w8a8", "w8a8_tc", "w8a8_gemv", "flash_decode", "decode_loop"),
        ATTN_COUNTERS[1:], 10.0, n_epochs)
    for bits in (8, (8, 8), 4, 0):
        _check_generate(engine, prompts, caps, bits)
    # two replays of the engine's captured step from the same state
    n0 = len(engine.captures)
    a = engine.generate(prompts, caps)
    b = engine.generate(prompts, caps)
    check(len(engine.captures) == n0 and np.array_equal(a.tokens, b.tokens)
          and np.array_equal(a.lengths, b.lengths),
          "granite: two replays of one captured MoE step differ")
    c, chunked_ms = _timed(lambda: engine.generate_via_chunks(
        prompts, caps, k=16))
    check(np.array_equal(c.tokens, a.tokens)
          and np.array_equal(c.lengths, a.lengths),
          "granite: chunked decode (k=16) != generate")
    log(f"slice: granite-moe-1b-a400m: generate == generate_reference at "
        f"W8A16, W8A8, W4A16 and bf16; two replays bitwise equal; chunked "
        f"(k=16, {chunked_ms:.0f} ms) == generate")
    timings = {"W8A16": decode_step_timing(engine, prompts, 8, "W8A16",
                                           loop=True)}
    return dict(runs=runs, timings=timings, chunked_ms=chunked_ms,
                trace=trace_steps(engine, prompts, 8),
                captures=engine.captures)


def internvl2_phase(cfg, n_epochs: int = 2):
    """internvl2-26b's language model (48 layers, D 6144, 48 heads of 128
    over 8, vocab 92,553; 256 zero patch embeddings ahead of each prompt),
    once every earlier engine is freed: ``dftsp`` epochs at W8A16 (K6; no
    unfused decode kernel), continuously over the arena (K7);
    ``generate == generate_reference`` and paged == slab == ``generate`` at
    W8A16 and W8A8; the decode step's times, one step traced; the device
    memory peak."""
    torch.cuda.reset_peak_memory_stats()
    prompts, caps = _prompts(cfg, BATCH, S_MAX, N_MAX)
    engine = _family_engine(cfg, "")
    for bits, tier in ((8, "fused"), ((8, 8), "fused"), (0, "flash")):
        check(engine.decode_tier(bits) == tier,
              f"internvl2 at bits={bits}: decode tier "
              f"{engine.decode_tier(bits)}, expected {tier}")
    unfused = ("flash_decode", "flash_decode_paged")
    runs = {"internvl2_dftsp_w8a16": epoch_path(
        engine, "internvl2_dftsp_w8a16", "W8A16", "dftsp",
        ("flash_decode_fused", "w8a16", "w8a16_tc", "w8a16_gemv",
         "decode_loop"),
        unfused + ("flash_decode_fused_paged",) + W8A16_ONLY, 10.0,
        n_epochs)}
    for bits in (8, (8, 8)):
        _check_generate(engine, prompts, caps, bits)
    runs["internvl2_continuous_w8a16"] = continuous_phase(
        engine, launched=("flash_decode_fused_paged", "w8a16", "w8a16_tc",
                          "w8a16_gemv", "decode_loop"),
        idle=unfused + ("flash_decode_fused",),
        label="internvl2_continuous_w8a16", n_epochs=2)
    paged = {str(bits): paged_equivalence_phase(
        engine, prompts, caps, bits=bits, step_timing=False)
        for bits in (8, (8, 8))}
    log("slice: internvl2-26b: generate == generate_reference and paged == "
        "slab == generate at W8A16 and W8A8")
    timings = {"W8A16": decode_step_timing(engine, prompts, 8, "W8A16",
                                           loop=True)}
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: internvl2-26b: device memory peak {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    trace = trace_steps(engine, prompts, 8)
    return dict(runs=runs, timings=timings, paged=paged, trace=trace,
                kept_tables=kept_tables(engine), captures=engine.captures,
                memory_peak_bytes=peak)


def _drain(engine, st, k: int):
    """Segments of ``k`` steps until no row of the cohort can emit: the
    final (out, lengths)."""
    while True:
        st = engine.generate_chunked(st, k)
        out, lengths, done, t = engine.poll_chunked(st)
        if engine.exhausted(lengths, done, st.caps_host, t):
            return out, lengths


def refill_phase(engine, prompts, bits=8, k: int = 16, cap: int = 40):
    """A mid-cohort refill through the device loop, held bitwise.  Row 1
    (cap 5) stops in the first segment of ``k`` steps; a new prompt is
    refilled into its slot at the cohort's step t = k and the cohort is
    driven to its end.  The refilled row must equal the same prompt
    refilled at the same step into a cohort whose only other live row had
    cap k (its rows do not reach each other); and, for a recurrent state
    (xLSTM, no attention slots), the same prompt served alone by
    ``generate``, as the JAX package's
    ``test_refill_recurrent_family_matches_solo_decode`` holds.  (Zamba2's
    and Whisper's refilled rows attend over the zero K/V of the slots
    between their prompt and the cohort's position, and decode at
    positions k later than alone, in the JAX package as here.)"""
    import numpy as np
    B, n_max = engine.batch_capacity, engine.n_max
    new = prompts[2][: engine.s_max // 2][::-1]
    caps = [n_max] * B
    caps[1] = 5
    rows = {}
    for label, ps, cs in (("cohort", prompts, caps),
                          ("alone", [prompts[0]], [k])):
        st = engine.start_chunked(ps, cs, quant_bits=bits)
        st = engine.generate_chunked(st, k)
        _, lengths, _, t = engine.poll_chunked(st)
        check(t == k and (label == "alone" or lengths[1] == 5),
              f"{engine.cfg.arch_id} refill ({label}): t = {t}, lengths "
              f"{lengths.tolist()} after the first segment")
        st = engine.refill_chunked(st, [1], [new], [cap], t_now=t)
        out, lengths = _drain(engine, st, k)
        rows[label] = out[1, :lengths[1]]
    check(np.array_equal(rows["cohort"], rows["alone"]),
          f"{engine.cfg.arch_id}: the refilled row differs between a full "
          f"cohort and one with no other live row")
    res = dict(t_now=k, cap=cap, refilled_len=int(len(rows["cohort"])))
    if engine.cfg.family == "ssm":
        solo = engine.generate([new], [cap], quant_bits=bits)
        check(np.array_equal(rows["cohort"],
                             solo.tokens[0, :solo.lengths[0]]),
              f"{engine.cfg.arch_id}: the refilled row != the same prompt "
              f"served alone")
        res["equals_solo_generate"] = True
    log(f"refill: {engine.cfg.arch_id} row refilled at step {k} "
        f"({res['refilled_len']} tokens) == the same prompt refilled into a "
        f"cohort with no other live row"
        + (" == served alone by generate" if "equals_solo_generate" in res
           else "") + ", bitwise")
    return res


def continuous_slab_phase(engine, idle, label, rate: float = 10.0,
                          n_epochs: int = 2, k: int = 16):
    """``dftsp`` through ``ContinuousRuntime`` + ``EngineContinuousExecutor``
    on the slab (no arena: these families are not paged-capable), chunk
    k, counted on its own: the device loop must launch and no counter of
    ``idle``; requests are conserved."""
    from repro_torch.core.environment import paper_env
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.runtime import (ContinuousRuntime,
                                             EngineContinuousExecutor)
    runtime = ContinuousRuntime(
        paper_env(engine.cfg.arch_id, "W8A16"), get_policy("dftsp"),
        EngineContinuousExecutor(engine, seed=0), k=k)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = runtime.run(rate=rate, n_epochs=n_epochs, seed=0, warmup_epochs=0)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    log(f"{label}: dftsp on {engine.cfg.arch_id} over the slab, k={k}, "
        f"{n_epochs} epochs at rate {rate}: served={m.served} dropped="
        f"{m.dropped} shed={m.shed} tokens={m.generated_tokens} mid-epoch "
        f"admissions={m.admitted_mid_epoch} methods={m.served_by_method} in "
        f"{run_ms:.0f} ms; launches {counts}")
    check(m.served > 0 and m.generated_tokens > 0,
          f"{label} served nothing")
    check(counts["decode_loop"] > 0, f"{label}: no device loop launched")
    for c in idle:
        check(counts[c] == 0, f"{label}: {c} launched {counts[c]} times on "
              f"a path that has no kernel")
    check(m.arrived == m.served + m.dropped + m.shed
          + len(m.final_queue_rids) + len(m.in_flight_rids),
          f"{label}: requests not conserved")
    return dict(served=m.served, dropped=m.dropped, shed=m.shed,
                tokens=m.generated_tokens,
                admitted_mid_epoch=m.admitted_mid_epoch,
                methods=m.served_by_method, run_ms=run_ms, launches=counts)


def recurrent_phase(cfg, n_epochs: int = 2):
    """xlstm-1.3b, zamba2-7b or whisper-tiny at full width and depth (B =
    8, s' = 512, n_max = 128, bf16, random weights from a seed), once every
    earlier engine is freed.  Their quantized trees are dequantized at
    load and their decode runs no kernel, as in the JAX package: no K1-K7
    counter may move on any of their paths.  ``generate ==
    generate_reference`` at bf16 and W8A16, each on the first ``generate``
    after its loop's capture (before anything else runs at that
    precision); chunked (k = 16) == ``generate``; a mid-cohort refill
    (``refill_phase``); ``dftsp`` epochs at W8A16; ``dftsp`` through
    ``ContinuousRuntime`` on the slab (k = 16); the decode step eager and
    as one CUDA graph, ``generate`` with the eager loop against the device
    loop; one step traced; the device memory peak."""
    import numpy as np
    from repro_torch.kernels import ops
    tag = cfg.arch_id.split("-")[0]
    torch.cuda.reset_peak_memory_stats()
    prompts, caps = _prompts(cfg, BATCH, S_MAX, N_MAX)
    engine = _family_engine(cfg, "")
    check(engine.decode_tier(8) == "none" and not engine.paged_capable,
          f"{cfg.arch_id}: expected no kernel tier and no paged path")
    kernels = tuple(c for c in ops.launch_counts() if c != "decode_loop")
    ops.reset_launch_counts()
    first = {}
    for bits in (0, 8):
        n0 = len(engine.captures)
        (_, ms) = _timed(lambda: _check_generate(engine, prompts, caps, bits))
        check(len(engine.captures) == n0 + 1,
              f"{cfg.arch_id} bits={bits}: the checked generate was not the "
              f"first after a capture")
        first[str(bits)] = ms
    a = engine.generate(prompts, caps)
    c, chunked_ms = _timed(lambda: engine.generate_via_chunks(prompts, caps,
                                                              k=16))
    check(np.array_equal(c.tokens, a.tokens)
          and np.array_equal(c.lengths, a.lengths),
          f"{cfg.arch_id}: chunked decode (k=16) != generate")
    refill = refill_phase(engine, prompts)
    counts = ops.launch_counts()
    check(counts["decode_loop"] > 0 and not any(counts[k] for k in kernels),
          f"{cfg.arch_id}: a kernel launched, or no device loop ({counts})")
    log(f"slice: {cfg.arch_id}: generate == generate_reference at bf16 and "
        f"W8A16, each the first generate after its capture (check ms "
        f"{first}); chunked (k=16, {chunked_ms:.0f} ms) == generate; no "
        f"kernel launched ({counts})")
    runs = {f"{tag}_dftsp_w8a16": epoch_path(
        engine, f"{tag}_dftsp_w8a16", "W8A16", "dftsp", ("decode_loop",),
        kernels, 10.0, n_epochs)}
    runs[f"{tag}_continuous_slab"] = continuous_slab_phase(
        engine, kernels, f"{tag}_continuous_slab")
    timings = {"W8A16": decode_step_timing(engine, prompts, 8, "W8A16",
                                           loop=True)}
    check(not timings["W8A16"]["kernel_calls_per_step"],
          f"{cfg.arch_id}: a decode step launched kernels "
          f"{timings['W8A16']['kernel_calls_per_step']}")
    trace = trace_steps(engine, prompts, 8)
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: {cfg.arch_id}: device memory peak {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    return dict(runs=runs, timings=timings, refill=refill,
                first_generate_check_ms=first, chunked_ms=chunked_ms,
                trace=trace, captures=engine.captures,
                memory_peak_bytes=peak)


def zamba2_instruct_phase(cfg, n_epochs: int = 2):
    """zamba2-7b-instruct (the published block: 81 Mamba2 layers of two
    groups, two shared blocks at 13 sites over concat(x, embedding)) at
    full width and depth, last of the served models (B = 8, s' = 512,
    n_max = 128, bf16, random weights from a seed, W8A16 dequantized at
    load).  ``generate == generate_reference`` at W8A16 on the first
    ``generate`` after its capture; ``dftsp`` epochs at W8A16 counted on
    their own (the launches its KERNELS rows report): ``mamba2_decode``'s
    two kernels, ``add_norm``, ``rope_qk_write``, K4 (``flash_decode``,
    each site's attention) and the device loop launch, no other K1-K7
    counter moves; one decode step's kernel calls (each Mamba2 layer's
    two, each site's rope and write and its K4), its eager and device ms;
    the device memory peak."""
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    prompts, caps = _prompts(cfg, BATCH, S_MAX, N_MAX)
    engine = _family_engine(cfg, "")
    check(engine.decode_tier(8) == "flash" and not engine.paged_capable,
          f"{cfg.arch_id}: expected the sites on K4 (tier \"flash\", got "
          f"{engine.decode_tier(8)!r}) and no paged path")
    own = ("mamba2_scan_step", "mamba2_gate_norm", "add_norm",
           "rope_qk_write", "flash_decode")
    others = tuple(c for c in ops.launch_counts()
                   if c not in own + ("decode_loop",))
    n0 = len(engine.captures)
    (_, check_ms) = _timed(lambda: _check_generate(engine, prompts, caps, 8))
    check(len(engine.captures) == n0 + 1,
          f"{cfg.arch_id}: the checked generate was not the first after a "
          f"capture")
    label = "zamba2i_dftsp_w8a16"
    runs = {label: epoch_path(engine, label, "W8A16", "dftsp",
                              ("decode_loop",) + own, others, 10.0,
                              n_epochs)}
    timing = decode_step_timing(engine, prompts, 8, "W8A16")
    calls = timing["kernel_calls_per_step"]
    L, n_sites = cfg.n_layers, len(cfg.hybrid.sites)
    check(calls.get("mamba2_scan_step") == calls.get("mamba2_gate_norm") == L
          and calls.get("rope_qk_write") == calls.get("flash_decode")
          == n_sites and calls.get("add_norm", 0) > L
          and set(calls) <= set(own),
          f"{cfg.arch_id}: a decode step launched {calls}, expected "
          f"mamba2_decode {L} times, rope_qk_write and flash_decode "
          f"{n_sites} each, add_norm and nothing else")
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: {cfg.arch_id}: generate == generate_reference at W8A16 "
        f"({check_ms:.0f} ms); a step's kernel calls {calls}; device "
        f"memory peak {peak / 2**30:.2f} GiB")
    return dict(runs=runs, timings={"W8A16": timing},
                first_generate_check_ms=check_ms, captures=engine.captures,
                memory_peak_bytes=peak)


def kept_tables(engine):
    """The dequantized embedding tables the engine keeps, in bytes per
    precision and counted once per storage: W8A16 and W8A8 quantize the
    table alike and must hold one between them."""
    tables = engine.kept_tables()
    check(8 in tables and tables.get((8, 8)) is tables[8],
          f"{engine.cfg.arch_id}: W8A16 and W8A8 keep separate embedding "
          f"tables ({sorted(map(str, tables))})")
    per = {str(b): t.numel() * t.element_size() for b, t in tables.items()}
    distinct = sum({t.untyped_storage().data_ptr():
                    t.numel() * t.element_size()
                    for t in tables.values()}.values())
    log(f"{engine.cfg.arch_id}: kept embedding tables, bytes per precision "
        f"{per}; {distinct} bytes held ({distinct / 1e9:.3f} GB), "
        f"{sum(per.values()) - distinct} bytes shared between precisions")
    return dict(bytes_per_precision=per, bytes_held=distinct)


# ---------------------------------------------------------------------------
# Training phase (M10)
# ---------------------------------------------------------------------------


def _train_counts_zero(what):
    """Training runs float weights: no K1-K7 counter (nor the decode loop)
    may move."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    check(not any(counts.values()),
          f"training {what}: a kernel launched ({counts})")


def _train_cfg(arch, over):
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import reduced
    cfg = reduced(get_arch(arch))
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in over.items()}
    return cfg.scaled(dtype="float32", **kw)


def train_small_phase():
    """Phase 10 (a) and (c): one reduced float32 model of each family
    trains ``TRAIN_SMALL_STEPS`` steps on the card and on the CPU from the
    same weights (drawn on the CPU from seed 0) and batches; the loss every
    step, and grad_norm and lr at the first, must agree within
    ``TRAIN_TOL``, grad_norm and lr at later steps within
    ``TRAIN_TOL_LATER``.  Then olmo-1b's
    (params, AdamW state) on the card go through a checkpoint under
    ``build/`` and back onto the card, bitwise."""
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer, TrainState, checkpoint
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.utils.tree import tree_leaves
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_SMALL_STEPS)
    out, kept = {}, None
    ops.reset_launch_counts()
    for arch, over in TRAIN_SMALL:
        cfg = _train_cfg(arch, over)
        cpu = Trainer(cfg, batch=2, seq=32, opt_cfg=opt, device="cpu")
        gpu = Trainer(cfg, batch=2, seq=32, opt_cfg=opt, device="cuda")
        s_cpu = cpu.init_state()
        params = bridge.to_device(s_cpu.params, "cuda")
        s_gpu, hg = gpu.run(TRAIN_SMALL_STEPS,
                            state=TrainState(params, adamw_init(params)),
                            log_every=1, log=lambda s: None)
        _, hc = cpu.run(TRAIN_SMALL_STEPS, state=s_cpu, log_every=1,
                        log=lambda s: None)
        err = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(hg, hc)]
               for k in ("loss", "grad_norm", "lr")}
        label = arch + ("-mixed" if over else "")
        out[label] = dict(rel_err=err, loss_card=[h["loss"] for h in hg],
                          loss_cpu=[h["loss"] for h in hc])
        check(all(e <= TRAIN_TOL for e in err["loss"])
              and err["grad_norm"][0] <= TRAIN_TOL
              and err["lr"][0] <= TRAIN_TOL
              and all(e <= TRAIN_TOL_LATER for k in ("grad_norm", "lr")
                      for e in err[k][1:]),
              f"training reduced {label}: card against CPU {err} beyond "
              f"{TRAIN_TOL} (loss; the first step) or {TRAIN_TOL_LATER} "
              f"(later steps)")
        if kept is None:
            kept = s_gpu
    path = ROOT / "build" / "chip_smoke_train.npz"
    path.parent.mkdir(exist_ok=True)
    try:
        checkpoint.save(str(path), (kept.params, kept.opt))
        like = (kept.params, adamw_init(kept.params))
        back = checkpoint.restore(str(path), like)
    finally:
        path.unlink(missing_ok=True)
    check(all(b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
              for a, b in zip(tree_leaves((kept.params, kept.opt)),
                              tree_leaves(back))),
          "training: the checkpoint round trip on the card changed a leaf")
    _train_counts_zero("reduced")
    log(f"training (reduced, float32, {TRAIN_SMALL_STEPS} steps): card == "
        f"CPU within {TRAIN_TOL} (relative) in the loss every step and in "
        f"grad_norm and lr at the first, {TRAIN_TOL_LATER} after; the "
        f"olmo-1b checkpoint round trip on the card bitwise; no kernel "
        f"launched: {json.dumps(out)}")
    return out


def train_step_breakdown(tr, state, top: int = 15):
    """Steps of ``tr`` under the remat policy (the launcher's step): one to
    warm up; one with the forward + backward (``value_and_grad``) and the
    AdamW update timed apart between synchronizations, each beside its
    bound (the forward and backward's matmul and attention operations over
    the bf16 peak, counted without the recompute; AdamW's bytes: params,
    grads and both moments read once, params and moments written once);
    one under ``torch.profiler``: kernels, busy share, the ``top`` kernels
    by time."""
    import repro_torch.train.trainer as trm
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.utils.remat import remat_scan
    from repro_torch.utils.tree import tree_leaves
    cfg, B, S = tr.cfg, tr.batch, tr.seq
    spans = {}
    real = {"value_and_grad": trm.value_and_grad,
            "adamw_update": trm.adamw_update}

    def timed(key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[key](*a, **kw)
            torch.cuda.synchronize()
            spans[key] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    quiet = dict(log=lambda s: None)
    with remat_scan(True):
        state, _ = tr.run(1, state=state, **quiet)
        for key in real:
            setattr(trm, key, timed(key))
        try:
            state, _ = tr.run(1, state=state, **quiet)
        finally:
            for key, fn in real.items():
                setattr(trm, key, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = tr.run(1, state=state, **quiet)
            torch.cuda.synchronize()
    leaves = tree_leaves(state.params)
    n = sum(p.numel() for p in leaves)
    adamw_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                      for p in leaves)
    # every weight is a matmul's but an untied embedding table (a gather)
    n_mm = n if cfg.tie_embeddings else n - cfg.vocab_padded() * cfg.d_model
    fb_ops = 6 * n_mm * B * S + 3 * 4 * B * S * S * cfg.d_model * cfg.n_layers
    out = dict(forward_backward_ms=spans["value_and_grad"],
               adamw_ms=spans["adamw_update"],
               forward_backward_bound_ms=bound_ms(0, fb_ops, "bf16")[0],
               adamw_bound_ms=bound_ms(adamw_bytes, 0, "bf16")[0],
               params=n, adamw_bytes=adamw_bytes)
    events = _kernel_events(prof)
    if events:
        out.update(kernels=len(events), **_kernel_summary(events, top))
    log(f"training olmo-1b step breakdown (remat on): forward + backward "
        f"{out['forward_backward_ms']:.2f} ms (bound "
        f"{out['forward_backward_bound_ms']:.2f}), AdamW "
        f"{out['adamw_ms']:.2f} ms (bound {out['adamw_bound_ms']:.2f}, "
        f"{adamw_bytes / 1e9:.1f} GB); trace: {json.dumps(out)}")
    return out


def train_full_phase(cfg):
    """Phase 10 (b): full-width OLMo-1B trains ``TRAIN_STEPS`` steps
    through ``repro_torch.launch.train.main`` at its defaults (batch 16,
    seq 256, lr 3e-4, remat on), each step timed between synchronizations
    (the launcher's step function is wrapped here, which leaves its loop
    as it is): every loss finite, the last below the first; ms a step
    (median of steps 2..N), tokens/s, the memory peak.  Then one step
    through ``Trainer`` with remat off from the same seed: its loss and
    grad_norm equal the first launcher step's within ``TRAIN_FULL_TOL``,
    and its peak beside the remat peak; then ``train_step_breakdown``."""
    import statistics
    import repro_torch.launch.train as lt
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    B, S = 16, 256
    steps = []
    real = lt.make_train_step_fn

    def timed(model, opt_cfg=None, microbatches=1):
        step = real(model, opt_cfg, microbatches)

        def run(params, opt, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              loss=float(out[2]["loss"]),
                              grad_norm=float(out[2]["grad_norm"])))
            return out
        return run

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    lt.make_train_step_fn = timed
    try:
        t0 = time.perf_counter()
        rc = lt.main(["--arch", cfg.arch_id, "--steps", str(TRAIN_STEPS),
                      "--device", "cuda"])
        total_s = time.perf_counter() - t0
    finally:
        lt.make_train_step_fn = real
    peak_remat = torch.cuda.max_memory_allocated()
    _train_counts_zero("olmo-1b")
    losses = [st["loss"] for st in steps]
    check(rc == 0 and len(steps) == TRAIN_STEPS,
          f"launch.train returned {rc} after {len(steps)} steps")
    check(all(math.isfinite(x) for x in losses),
          f"olmo-1b training: a loss is not finite {losses}")
    check(losses[-1] < losses[0],
          f"olmo-1b training: the last loss {losses[-1]} is not below the "
          f"first {losses[0]}")
    ms = statistics.median(st["ms"] for st in steps[1:])
    _free()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, batch=B, seq=S, opt_cfg=AdamWConfig(
        lr=3e-4, total_steps=TRAIN_STEPS), remat=False, seed=0,
        device="cuda")
    st0 = tr.init_state()
    (st0, hist), off_ms = _timed(lambda: tr.run(1, state=st0,
                                                log=lambda s: None))
    row = hist[0]
    peak_off = torch.cuda.max_memory_allocated()
    breakdown = train_step_breakdown(tr, st0)
    del tr, st0
    _train_counts_zero("olmo-1b, remat off")
    err = {k: abs(row[k] - steps[0][k]) / abs(steps[0][k])
           for k in ("loss", "grad_norm")}
    check(all(e <= TRAIN_FULL_TOL for e in err.values()),
          f"olmo-1b: remat off's first step {row} != the launcher's "
          f"{steps[0]} ({err} > {TRAIN_FULL_TOL})")
    out = dict(steps=TRAIN_STEPS, batch=B, seq=S, launcher_s=total_s,
               ms_per_step_median=ms, first_step_ms=steps[0]["ms"],
               tokens_per_s=B * S / (ms / 1e3), losses=losses,
               grad_norms=[st["grad_norm"] for st in steps],
               step_ms=[st["ms"] for st in steps],
               peak_bytes_remat=peak_remat, peak_bytes_no_remat=peak_off,
               no_remat_first_step_ms=off_ms, no_remat_rel_err=err,
               breakdown=breakdown)
    log(f"training olmo-1b at full width (16 layers, d_model 2048, vocab "
        f"50,304, bf16; B {B} x S {S}, remat on, {TRAIN_STEPS} steps through "
        f"launch.train): {ms:.2f} ms a step (median of steps 2..N), "
        f"{B * S / (ms / 1e3):.0f} tokens/s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, peak {peak_remat / 2**30:.2f} GiB; remat off "
        f"(one step through Trainer, {off_ms:.0f} ms): peak "
        f"{peak_off / 2**30:.2f} GiB, first-step loss and grad_norm within "
        f"{err} of the launcher's: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the hardware record, the serve launcher's cost models, the mesh
# of one, the roofline and the dry run
# ---------------------------------------------------------------------------

DRYRUN_CASES = (("olmo-1b", "train_4k", "--single-pod-only"),
                ("qwen3-1.7b", "decode_32k", "--multi-pod-only"))


def start_dryruns():
    """Phase 11 (e), started at the beginning of the run so that it
    overlaps the card's work: each case in a process of its own (its own
    process-group state), CPU only, one thread each."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    (ROOT / "build").mkdir(exist_ok=True)
    procs = []
    for arch, shape, mesh in DRYRUN_CASES:
        out = ROOT / "build" / f"dryrun_{arch}_{shape}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, mesh, "--json", str(out)]
        if out.exists():
            out.unlink()
        procs.append((arch, shape, out, time.time(), subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    import atexit
    atexit.register(_stop, [p[-1] for p in procs])
    return procs


def _stop(procs):
    """Stop the dry-run processes that are still running (a failed run)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryruns(procs):
    """Phase 11 (e): each dry-run case exits 0; its record and seconds."""
    out = {}
    for arch, shape, path, t0, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        check(proc.returncode == 0, f"dryrun {arch} x {shape} exited "
              f"{proc.returncode}: {text[-2000:]}")
        # from its start to the moment it wrote its record
        secs = path.stat().st_mtime - t0
        (rec,) = json.loads(path.read_text())["results"]
        keep = {k: rec[k] for k in (
            "mesh", "chips", "bytes_per_device", "fits", "t_compute",
            "t_memory", "t_collective", "bottleneck", "collective_bytes",
            "traced_flops", "model_flops", "t_trace_s")}
        log(f"phase 11 (e): dryrun {arch} x {shape} x {rec['mesh']}: exit 0, "
            f"its record written {secs:.1f} s after its start (import "
            f"included; it ran beside the card's phases): "
            f"{json.dumps(keep)}")
        out[f"{arch} {shape}"] = dict(keep, seconds=secs)
    return out


def record_phase(card):
    """Phase 11 (a): the card against the port's ``H100`` record."""
    import dataclasses
    from repro_torch.config import H100, H100_INT8_OPS
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 11 (a): nvidia-smi {card!r}; torch: {name}, total_memory "
        f"{total} B ({total / 2**30:.3f} GiB); config.H100 "
        f"{dataclasses.asdict(H100)}, int8 peak {H100_INT8_OPS:.4g}")
    check("H100" in name, f"the card is {name!r}, not an H100")
    check(abs(total - H100.hbm_bytes) <= 0.01 * H100.hbm_bytes,
          f"total_memory {total} is not within 1 % of H100.hbm_bytes "
          f"{H100.hbm_bytes}")
    return dict(card=card, name=name, total_memory=total,
                hbm_bytes=H100.hbm_bytes)


def serve_env_phase():
    """Phase 11 (b): the serve launcher at full-width BLOOM-3B, W8A16, 2
    epochs at rate 10, with ``--h100-env`` and with the paper's cost
    model: exit 0, K1 and K4 launch; served, tokens and methods; the
    H100 cost model's time for the first epoch's batch beside that batch's
    measured ``generate`` ms (the executor's call, between
    synchronizations)."""
    import io
    import repro_torch.launch.serve as lserve
    from repro_torch.core import problem
    from repro_torch.kernels import ops
    from repro_torch.serving import runtime as rt
    out = {}
    for label, flags in (("h100_env", ["--h100-env"]), ("paper_env", [])):
        batches = []
        real = rt.EngineExecutor.execute

        def timed(self, env, decision):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = real(self, env, decision)
            torch.cuda.synchronize()
            batches.append((env, list(decision.selected),
                            (time.perf_counter() - t0) * 1e3))
            return n

        ops.reset_launch_counts()
        buf = io.StringIO()
        rt.EngineExecutor.execute = timed
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = lserve.main(["--arch", "bloom-3b", "--quant", "W8A16",
                                  "--epochs", "2", "--rate", "10",
                                  "--device", "cuda"] + flags)
            run_s = time.perf_counter() - t0
        finally:
            rt.EngineExecutor.execute = real
        counts = ops.launch_counts()
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("[serve]")]
        check(rc == 0 and len(line) == 1,
              f"serve {label}: exit {rc}, output {buf.getvalue()[-500:]}")
        check(counts["w8a16"] > 0 and counts["flash_decode"] > 0,
              f"serve {label}: K1 or K4 did not launch: {counts}")
        first = next(((env, sel, ms) for env, sel, ms in batches if sel),
                     None)
        check(first is not None, f"serve {label}: no batch was served")
        env, sel, ms = first
        row = dict(line=line[0], run_s=run_s,
                   launches={k: v for k, v in counts.items() if v},
                   first_batch=len(sel), first_batch_generate_ms=ms,
                   env_C=env.C, env_M=env.M)
        if label == "h100_env":
            row["first_batch_cost_model_ms"] = \
                problem.batch_compute_time(env, sel) * 1e3
        log(f"phase 11 (b): serve --arch bloom-3b {' '.join(flags)}: "
            f"{line[0]} in {run_s:.1f} s; first batch {len(sel)} requests, "
            f"generate {ms:.1f} ms"
            + (f", H100 cost model {row['first_batch_cost_model_ms']:.3f} ms"
               if label == "h100_env" else "")
            + f"; {json.dumps(row)}")
        out[label] = row
        _free()
    return out


def mesh_step_phase(cfg):
    """Phase 11 (c): one full-width OLMo-1B step through the mesh path
    (``make_host_mesh()``: an NCCL group of one, params and AdamW state
    placed by ``param_specs(fsdp=False)``, the step inside the mesh's axis
    context, remat on) against one step of the plain
    ``make_train_step_fn`` from the same seed and batch: the loss,
    grad_norm and every param leaf bitwise equal (deterministic
    algorithms on for both)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps as lsteps
    from repro_torch.models.api import build_model
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                             adamw_init)
    from repro_torch.train.trainer import to_batch
    from repro_torch.utils.remat import remat_scan
    from repro_torch.utils.sharding import P
    from repro_torch.utils.tree import tree_leaves
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS)
    batch = to_batch(SyntheticLM(cfg, 16, 256).next_batch(), "cuda")

    def run(on_mesh):
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw_init(params)
        step = lsteps.make_train_step_fn(model, opt_cfg)
        if not on_mesh:
            with remat_scan(True):
                params, opt, m = step(params, opt, batch)
            return tree_leaves(params), m, None
        own = lmesh.owns_group("cuda")
        try:
            mesh = lmesh.make_host_mesh(device_type="cuda")
            info = dict(backend=dist.get_backend(),
                        world=dist.get_world_size(),
                        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
            specs = lsteps.param_specs(model, mesh, fsdp=False)
            params = lsteps.shardings(mesh, specs, params)
            opt = lsteps.shardings(
                mesh, AdamWState(step=P(), mu=specs, nu=specs), opt)
            with lsteps.mesh_step(mesh), remat_scan(True):
                params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
        finally:
            if own:
                dist.destroy_process_group()
        return tree_leaves(params), m, info

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (plain, mp, _), plain_ms = _timed(lambda: run(False))
        (meshed, mm, info), mesh_ms = _timed(lambda: run(True))
    finally:
        torch.use_deterministic_algorithms(det)
    check(info["backend"] == "nccl" and info["world"] == 1
          and info["mesh"] == {"data": 1, "model": 1},
          f"the mesh of one: {info}")
    check(all(type(t) is torch.Tensor for t in meshed),
          "a mesh of one placed a DTensor")
    same = [torch.equal(a, b) for a, b in zip(plain, meshed)]
    check(torch.equal(mp["loss"], mm["loss"])
          and torch.equal(mp["grad_norm"], mm["grad_norm"]) and all(same),
          f"olmo-1b: the mesh step is not the plain step bitwise: loss "
          f"{float(mp['loss'])} vs {float(mm['loss'])}, "
          f"{same.count(False)} of {len(same)} leaves differ")
    out = dict(mesh=info, loss=float(mm["loss"]),
               grad_norm=float(mm["grad_norm"]), leaves=len(same),
               plain_step_ms=plain_ms, mesh_step_ms=mesh_ms)
    log(f"phase 11 (c): olmo-1b at full width, one step through "
        f"make_host_mesh() ({info}) == the plain step bitwise: loss, "
        f"grad_norm and all {len(same)} leaves; {json.dumps(out)}")
    del plain, meshed
    _free()
    return out


def roofline_phase(cfg_olmo, train_full, sl):
    """Phase 11 (d): ``roofline_terms(*analytic_costs(...), 0, 1, H100)``
    beside the measured times: OLMo-1B's train step at B 16 x S 256
    (phase 10's launcher median, now through the mesh of one) and
    BLOOM-3B's decode step at B = 8 over a 640-slot cache (the device ms
    of its replayed W8A16 step, phase 5); each as a share of the
    roofline (bound / measured).  The analytic model counts bf16
    weights."""
    from repro_torch.config import H100, ShapeConfig, get_arch
    from repro_torch.roofline.analysis import (analytic_costs,
                                               dominant_term, roofline_terms)
    out = {}
    for name, arch_cfg, shape, ms in (
            ("olmo-1b train", cfg_olmo,
             ShapeConfig("olmo_train", 256, 16, "train"),
             train_full["ms_per_step_median"]),
            ("bloom-3b decode W8A16", get_arch("bloom-3b"),
             ShapeConfig("bloom_decode", S_MAX + N_MAX, BATCH,
                         "decode"),
             sl["timings"]["W8A16"]["decode_device_ms_per_step"])):
        flops, bytes_ = analytic_costs(arch_cfg, shape)
        terms = roofline_terms(flops, bytes_, 0, 1, H100)
        bound = max(terms.values()) * 1e3
        row = dict(flops=flops, bytes=bytes_,
                   **{k: v * 1e3 for k, v in terms.items()},
                   bottleneck=dominant_term(terms), bound_ms=bound,
                   measured_ms=ms, share=bound / ms)
        log(f"phase 11 (d): {name} at {shape}: roofline (ms) "
            f"{ {k: round(v * 1e3, 4) for k, v in terms.items()} }, "
            f"bound {bound:.3f} ms ({row['bottleneck']}) beside "
            f"{ms:.3f} ms measured: {row['share']:.1%} of the roofline")
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit (git archive): its "
                    "quantized matmuls' decode calls are timed in this run, "
                    "beside this tree's")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        log(f"FAILED: no src/repro_torch beside {Path(__file__).name}; run "
            f"it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is False: this script "
            "measures the CUDA kernels and has no CPU mode")
        return 2
    dryruns = start_dryruns()
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
    ptxas = ptxas_lines("quant_matmul", "qmm_tc")
    check(len(ptxas) == 2, f"ptxas -v reported {len(ptxas)} qmm_tc kernels")
    ptxas_a8 = ptxas_lines("quant_matmul", "qmm_a8_wgmma")
    # bf16 and float32 out
    check(len(ptxas_a8) == 2,
          f"ptxas -v reported {len(ptxas_a8)} qmm_a8_wgmma kernels")
    # K4/K5: fd_split over {f32, bf16} x {16-byte, element loads} x {slab,
    # paged}, and the merge fd_combine for f32 and bf16
    # the W8A8 GEMV: {bf16, f32} out x {16-byte, byte} loads
    ptxas_gv = ptxas_lines("quant_matmul", "qmm_a8_gemv")
    check(len(ptxas_gv) == 4,
          f"ptxas -v reported {len(ptxas_gv)} qmm_a8_gemv kernels")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in line
              for line in ptxas_gv), f"qmm_a8_gemv spills: {ptxas_gv}")
    # the W8A16 / W4A16 GEMV: bits 8 and 4
    ptxas_g16 = ptxas_lines("quant_matmul", "qmm_a16_gemv")
    check(len(ptxas_g16) == 2,
          f"ptxas -v reported {len(ptxas_g16)} qmm_a16_gemv kernels")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in line
              for line in ptxas_g16), f"qmm_a16_gemv spills: {ptxas_g16}")
    ptxas_fd = ptxas_lines("flash_decode", "fd_split")
    check(len(ptxas_fd) == 8,
          f"ptxas -v reported {len(ptxas_fd)} fd_split kernels")
    ptxas_fc = ptxas_lines("flash_decode", "fd_combine")
    check(len(ptxas_fc) == 2,
          f"ptxas -v reported {len(ptxas_fc)} fd_combine kernels")
    # K6/K7: fused_decode over {f32, bf16} x {a16, a8} x {tensor cores,
    # CUDA cores} (f32 at a16 on the CUDA cores only) x {slab, paged}
    ptxas_fu = ptxas_lines("flash_decode_fused", "fused_decode")
    check(len(ptxas_fu) == 14,
          f"ptxas -v reported {len(ptxas_fu)} fused_decode kernels")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in line
              for line in ptxas_fu), f"fused_decode spills: {ptxas_fu}")
    for line in (ptxas + ptxas_a8 + ptxas_gv + ptxas_g16 + ptxas_fd
                 + ptxas_fc + ptxas_fu):
        log(f"ptxas -v, {line}")

    with torch.no_grad():
        kernels = kernel_phase(args.parent)
        small_reference_phase()
        small_reference_phase("bloom-7b1", n_heads=2, bits_list=(8, (8, 8)),
                              paged_bits=(8, (8, 8)), tier="fused")
        small_family_phase()
        from repro_torch.config import get_arch
        cfg = get_arch("bloom-3b")
        check(cfg.d_model == 2560 and cfg.n_layers == 30
              and cfg.vocab == 250880 and cfg.dtype == "bfloat16",
              f"unexpected bloom-3b config {cfg}")
        sl = slice_phase(cfg)
        _free()                                  # BLOOM-3B's engines are gone
        cfg7 = get_arch("bloom-7b1")
        check(cfg7.d_model == 4096 and cfg7.n_layers == 30
              and cfg7.n_heads == 32 and cfg7.d_head == 128
              and cfg7.vocab == 250880 and cfg7.dtype == "bfloat16",
              f"unexpected bloom-7b1 config {cfg7}")
        sl7 = slice_7b1_phase(cfg7)
        _free()
        fam = {}
        for arch, want, phase in (
                ("qwen3-1.7b", dict(n_layers=28, d_model=2048, n_heads=16,
                                    n_kv_heads=8, d_head=128, vocab=151936,
                                    qk_norm=True), qwen3_phase),
                ("granite-moe-1b-a400m", dict(n_layers=24, d_model=1024,
                                              n_heads=16, n_kv_heads=8,
                                              d_head=64, vocab=49155),
                 granite_phase),
                ("internvl2-26b", dict(n_layers=48, d_model=6144, n_heads=48,
                                       n_kv_heads=8, d_head=128,
                                       vocab=92553), internvl2_phase),
                ("xlstm-1.3b", dict(family="ssm", n_layers=48, d_model=2048,
                                    n_heads=4, vocab=50304),
                 recurrent_phase),
                ("whisper-tiny", dict(family="audio", n_layers=4,
                                      d_model=384, n_heads=6, vocab=51865),
                 recurrent_phase),
                ("zamba2-7b", dict(family="hybrid", n_layers=81,
                                   d_model=3584, n_heads=32, n_kv_heads=32,
                                   d_head=112, vocab=32000),
                 recurrent_phase)):
            c = get_arch(arch)
            check(c.dtype == "bfloat16" and all(
                getattr(c, k) == v for k, v in want.items()),
                  f"unexpected {arch} config {c}")
            fam[arch] = phase(c)
            _free()                        # each engine goes before the next
        cz = get_arch("zamba2-7b-instruct")
        check(cz.n_layers == 81 and cz.d_model == 3584 and cz.d_head == 224
              and cz.ssm.n_groups == 2 and len(cz.hybrid.sites) == 13
              and cz.vocab == 32000 and cz.dtype == "bfloat16",
              f"unexpected zamba2-7b-instruct config {cz}")
        fam["zamba2-7b-instruct"] = zamba2_instruct_phase(cz)
        _free()
    # training needs autograd: outside no_grad
    train_small = train_small_phase()
    cfg_olmo = get_arch("olmo-1b")
    check(cfg_olmo.n_layers == 16 and cfg_olmo.d_model == 2048
          and cfg_olmo.n_heads == 16 and cfg_olmo.d_ff == 8192
          and cfg_olmo.vocab == 50304 and cfg_olmo.tie_embeddings
          and cfg_olmo.dtype == "bfloat16",
          f"unexpected olmo-1b config {cfg_olmo}")
    train_full = train_full_phase(cfg_olmo)
    _free()
    # phase 11: the hardware record, the cost models, the mesh, the roofline
    # and the dry run
    t11 = time.perf_counter()
    m = train_full["ms_per_step_median"]
    log(f"phase 11 (c): phase 10's {TRAIN_STEPS} launcher steps ran through "
        f"make_host_mesh() (a mesh of one): median {m:.2f} ms a step beside "
        f"{UNMESHED_OLMO_STEP_MS[0]}-{UNMESHED_OLMO_STEP_MS[1]} ms without "
        f"a mesh (earlier runs on the same card)")
    phase11 = dict(record=record_phase(card))
    with torch.no_grad():
        phase11["serve"] = serve_env_phase()
    phase11["mesh_step"] = mesh_step_phase(cfg_olmo)
    phase11["launcher_median_ms"] = m
    phase11["roofline"] = roofline_phase(cfg_olmo, train_full, sl)
    phase11["dryrun"] = finish_dryruns(dryruns)
    phase11["seconds"] = time.perf_counter() - t11
    log(f"summary phase 11 ({phase11['seconds']:.1f} s): "
        f"{json.dumps(phase11)}")
    # K2 and the W8A8 tier's eager activation quantization, timed inside
    # one W8A8 prefill of each model
    for name, s_ in (("quant_matmul_w8a8_tc", sl),
                     ("quant_matmul_w8a8_tc_bloom7b1", sl7)):
        kernels[name]["in_w8a8_prefill"] = s_["timings"]["W8A8"]["in_prefill"]
    # the GEMV and quantize_rowwise inside one W8A8 decode step of each
    for name, s_ in (("quant_matmul_w8a8", sl),
                     ("quant_matmul_w8a8_gemv_bloom7b1", sl7)):
        kernels[name]["in_w8a8_decode"] = s_["timings"]["W8A8"]["in_decode"]
    log(f"summary: {json.dumps(sl)}")
    log(f"summary bloom-7b1: {json.dumps(sl7)}")
    for arch, f in fam.items():
        log(f"summary {arch}: {json.dumps(f)}")
    training = dict(reduced=train_small, olmo_1b=train_full)
    log(f"summary training: {json.dumps(training)}")

    runs = {**sl["runs"], **sl7["runs"]}
    for f in fam.values():
        runs.update(f["runs"])
    rows = [kernel_row(entry, runs, kernels) for entry in KERNELS]
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

#!/usr/bin/env python3
"""Where the fused decode attention (K6, ``csrc/flash_decode_fused.cu``)
spends its time, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/fused_variants.py

It builds variants of the kernel from copies of its source with one phase
removed, doubled or changed (``VARIANTS``: text substitutions; a variant
whose text no longer matches the source is reported and skipped), beside
the source as it is, and times each call at BLOOM-7B1's decode shape (B =
8, D = 4096, 32 heads of 128, n_valid 576 of 640, bf16 x, int8 weights), a16
and a8, by CUDA-graph replay over input sets rotated through > 256 MB.  The
variant ``timers`` records ``%globaltimer`` at each phase boundary of every
block and ``%smid``: the mean and the largest time of each phase, how many
SMs hold 0, 1 or 2 blocks, and how many clusters of the launch fit the card
at once (``cudaOccupancyMaxActiveClusters``).  The source as it is also runs
with a cluster of 8 blocks a KV head instead of the plan's.  Last, the
parts of a three-launch alternative on the port's existing kernels: the
W8A8 GEMV for q, k, v and wo (4 calls) and K4 over the same cache.  The
variants compute wrong outputs by design: only the source as it is is
checked (``chip_smoke.py`` and the card tests do that).  Prints the card's
name and power limit, one line per measurement and a JSON object last.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_decode_fused.cu"

_LB = "__global__ void __launch_bounds__(FU_THREADS, 2)\nfused_decode"
_FETCH = "    if (iss_i < Rv) {\n      const int b = a.row0"
_COMPUTE = "      switch (dpl) {\n        case 4:"
_TILE4 = ("        case 4: warp_tile<4>(kw, vw, nj, s0 + j0, ev, q, wacc, wm, wl, "
          "G, dh, lane); break;")
_WAIT = ("      if (S == 3) cp_async_wait<1>();\n      else cp_async_wait<0>();\n"
         "      __syncthreads();")

# name -> [(text of the source, its replacement), ...]
VARIANTS = {
    "one_block_an_sm": [(_LB, _LB.replace(", 2)", ", 1)"))],
    "no_attention": [("info[2 * R + tid] = (nv + FU_BS - 1) / FU_BS;",
                      "info[2 * R + tid] = 0;")],
    "attention_copies_only": [(_COMPUTE, "      if (a.B > 0) continue;\n" + _COMPUTE)],
    "attention_compute_only": [(_FETCH, _FETCH.replace("iss_i < Rv)",
                                                       "iss_i < Rv && a.B < 0)"))],
    "attention_compute_twice": [(_TILE4, _TILE4.replace(
        " break;", " " + _TILE4.split(": ", 1)[1].replace(" break;", "") + " break;"))],
    "no_qkv_mma": [("          if (j < nsteps) {",
                    "          if (j < nsteps && a.B < 0) {")],
    "no_wo": [("const int nuo = ntw * ns;", "const int nuo = 0;")],
    "timers": [
        ("namespace {\n\nconstexpr int FU_THREADS",
         "namespace {\n\n__device__ unsigned long long fu_ts[1024][12];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n\nconstexpr int FU_THREADS"),
        ("  const T* x = static_cast<const T*>(a.x) + (size_t)a.row0 * D;\n",
         "  const T* x = static_cast<const T*>(a.x) + (size_t)a.row0 * D;\n"
         "  const int fu_blk = blockIdx.y * C + rank;\n"
         "  unsigned long long fu_wait = 0, fu_t0;\n"
         "  if (tid == 0) {\n    fu_ts[fu_blk][0] = gtime();\n    unsigned sm;\n"
         "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
         "    fu_ts[fu_blk][10] = sm;\n  }\n"),
        ("  if constexpr (MMA) {\n    AccT* part",
         "  if (tid == 0) fu_ts[fu_blk][1] = gtime();\n"
         "  if constexpr (MMA) {\n    AccT* part"),
        ("  cluster.sync();\n\n  // own rows",
         "  if (tid == 0) fu_ts[fu_blk][2] = gtime();\n  cluster.sync();\n"
         "  if (tid == 0) fu_ts[fu_blk][3] = gtime();\n\n  // own rows"),
        ("  // --- b. attention",
         "  if (tid == 0) fu_ts[fu_blk][4] = gtime();\n  // --- b. attention"),
        (_WAIT, "      fu_t0 = gtime();\n" + _WAIT
         + "\n      fu_wait += gtime() - fu_t0;"),
        ("  cp_async_wait<0>();\n  cluster.sync();",
         "  if (tid == 0) {\n    fu_ts[fu_blk][5] = gtime();\n"
         "    fu_ts[fu_blk][9] = fu_wait;\n  }\n"
         "  cp_async_wait<0>();\n  cluster.sync();\n"
         "  if (tid == 0) fu_ts[fu_blk][6] = gtime();"),
        ("  asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n}\n",
         "  if (tid == 0) fu_ts[fu_blk][7] = gtime();\n"
         "  asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n}\n"),
        ("}  // extern \"C\"",
         "int fu_read_timers(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, fu_ts, sizeof(fu_ts));\n}\n"
         "int fu_max_clusters(int C, int nkv, int D, int dh, int a8) {\n"
         "  int n = -1;\n"
         "  const Layout L = layout(C, 1, dh, D / C, 2, a8, true, FU_STAGES);\n"
         "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(C, nkv, 1);\n"
         "  cfg.blockDim = dim3(FU_THREADS, 1, 1);\n"
         "  cfg.dynamicSmemBytes = L.total;\n  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = C;\n  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n"
         "  auto k = a8 ? fused_decode<__nv_bfloat16, true, true, SlabAddr>\n"
         "              : fused_decode<__nv_bfloat16, false, true, SlabAddr>;\n"
         "  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "(int)L.total);\n"
         "  cudaOccupancyMaxActiveClusters(&n, k, &cfg);\n  return n;\n}\n"
         "}  // extern \"C\""),
    ],
}
PHASES = ("x", "qkv", "barrier1", "merge", "attention", "barrier2", "wo")


def build(names):
    """{name: loaded library} for the variants that apply, all compiled at
    once into build/fused_variants/."""
    from repro_torch.kernels import _build
    src = SOURCE.read_text()
    out_dir = ROOT / "build" / "fused_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                print(f"{name}: skipped, its text is not in the source",
                      flush=True)
                break
            text = text.replace(old, new, 1)
        else:
            cu = out_dir / f"{name}.cu"
            cu.write_text(text)
            so = out_dir / f"lib{name}.so"
            procs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed:\n{log.decode(errors='replace')[-3000:]}")
            continue
        lib = ctypes.CDLL(str(so))
        _build._declare(lib)
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.quant import ptq

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    libs = {"source": _build.library("flash_decode_fused")}
    libs.update(build(list(VARIANTS)))

    a = cs.ATTN7
    B, D, nh, nkv, dh, W, nv = (a[k] for k in ("B", "D", "nh", "nkv", "dh",
                                               "W", "n_valid"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, D), generator=gen, device=dev).to(torch.bfloat16)
    ws = {a8: cs._fused_weights(D, nh, nkv, dh, gen, dev, 8 if a8 else 16)[0]
          for a8 in (False, True)}
    w_bytes = sum(w.numel() * w.element_size() for w in ws[False])
    n_copy = max(1, min(8, math.ceil(cs.ROTATE_BYTES / (
        w_bytes + 2 * B * W * nkv * dh * 2))))
    wc = {a8: [[w.clone() for w in ws[a8]] for _ in range(n_copy)]
          for a8 in (False, True)}
    kv = [[torch.randn((B, W, nkv, dh), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)] for _ in range(n_copy)]
    cos, sin = ops._rope_rows(nv, dh, 1e4, dev)
    plan = fd.fused_plan(D, nkv, 1, dh)
    res = {}

    def call(i, a8):
        return fd.flash_decode_fused_cuda(x, *wc[a8][i], *kv[i], nv, -1, cos,
                                          sin, True, a8)

    def timed(label, plan_used):
        fd.fused_plan = lambda *_: plan_used
        for a8 in (False, True):
            ms = cs.device_ms(lambda i: call(i, a8), n_copy)
            res[f"{label} a{8 if a8 else 16}"] = ms
            print(f"{label:26s} a{8 if a8 else 16}: {ms * 1e3:8.1f} us",
                  flush=True)

    fused_plan = fd.fused_plan
    per8 = -(-D // 8 // 16) * 16
    plan8 = fd.FusedPlan(8, per8, per8, (), (), (), fd.FU_BS, ())
    with torch.no_grad():
        for name, lib in libs.items():
            _build._LIBS["flash_decode_fused"] = lib
            timed(name, plan)
            if name == "source":
                timed("source, clusters of 8", plan8)
        if "timers" in libs:
            lib = libs["timers"]
            _build._LIBS["flash_decode_fused"] = lib
            fd.fused_plan = lambda *_: plan
            lib.fu_read_timers.argtypes = [ctypes.c_void_p]
            lib.fu_max_clusters.argtypes = [ctypes.c_int] * 5
            for a8 in (False, True):
                tag = f"a{8 if a8 else 16}"
                fits = {C: lib.fu_max_clusters(C, nkv, D, dh, int(a8))
                        for C in (4, 8)}
                buf = np.zeros((1024, 12), np.uint64)
                for _ in range(3):
                    call(0, a8)
                torch.cuda.synchronize()
                lib.fu_read_timers(buf.ctypes.data)
                t = buf[:nkv * plan.cluster].astype(np.int64)
                sms = np.bincount(t[:, 10], minlength=132)
                ph = np.diff(t[:, :8], axis=1) / 1e3
                res[f"timers {tag}"] = dict(
                    total_us=float((t[:, 7].max() - t[:, 0].min()) / 1e3),
                    last_start_us=float((t[:, 0].max() - t[:, 0].min()) / 1e3),
                    phase_mean_us={k: float(ph[:, i].mean())
                                   for i, k in enumerate(PHASES)},
                    phase_max_us={k: float(ph[:, i].max())
                                  for i, k in enumerate(PHASES)},
                    attention_copy_wait_us=float(t[:, 9].mean() / 1e3),
                    sms_with_0_1_2_blocks=[int((sms == n).sum())
                                           for n in (0, 1, 2)],
                    clusters_that_fit={str(C): v for C, v in fits.items()})
                print(f"timers {tag}: {json.dumps(res[f'timers {tag}'])}",
                      flush=True)
        fd.fused_plan = fused_plan
        _build._LIBS["flash_decode_fused"] = libs["source"]
        # the three-launch alternative's parts on existing kernels (a8)
        xq, sx = ptq.quantize_rowwise(x)
        q = torch.randn((B, nh, dh), generator=gen, device=dev).to(
            torch.bfloat16)

        def gemvs(i):
            w = wc[True][i]
            for j in (0, 2, 4, 6):
                qm.quant_matmul_a8_cuda(xq, sx, w[j], w[j + 1], torch.bfloat16)

        def k4(i):
            fd.flash_decode_cuda(q, kv[i][0], kv[i][1], nv + 1)

        for label, fn in (("alternative: 4 GEMV + K4", lambda i: (gemvs(i), k4(i))),
                          ("alternative: 4 GEMV", gemvs),
                          ("alternative: K4", k4)):
            res[label] = cs.device_ms(fn, n_copy)
            print(f"{label:26s}: {res[label] * 1e3:8.1f} us", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

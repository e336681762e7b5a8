#!/usr/bin/env python3
"""Variants of the W8A16 / W4A16 GEMV (``qmm_a16_gemv`` in
``csrc/quant_matmul.cu``, K1 and K3 at decode) timed beside the source as
it is, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/gemv_variants.py            # every variant
    python3 scripts/gemv_variants.py ring4 w8_skip

Each variant is a copy of ``src/repro_torch`` under
``build/gemv_variants/<name>/`` with one change (``VARIANTS``: text
substitutions in the kernel source or the plan; a variant whose text no
longer matches is reported and skipped).  All trees are built at once, one
process each; then each tree, the source as it is first and last, runs in
a process of its own: a check of K1 and K3 against their plain versions at
BLOOM-3B's decode shapes (M = 8, bf16), ``ptxas -v`` of the kernel, and
``chip_smoke.decode_call_ms`` of K1 and K3 at BLOOM-3B's and BLOOM-7B1's
decode layers (each of a layer's six calls by CUDA-graph replay over
weights rotated through > 256 MB).  Prints the card's name and power
limit, one line per tree and a JSON object last.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CU = Path("csrc") / "quant_matmul.cu"
PY = Path("kernels") / "quant_matmul.py"

_STEP = """      uint4 cw[4];
      uint2 cx[XC];
#pragma unroll
      for (int i = 0; i < 4; ++i) cw[i] = w[d][i];
#pragma unroll
      for (int c = 0; c < XC; ++c) cx[c] = xw[d][c];
      const int k0 = kb + (j0 + (d + GV_DEPTH) * GV_WARPS) * KSTEP + 4 * t;
      a16_load_q<BITS>(q, N, ke, k0, n, w[d]);
#pragma unroll
      for (int c = 0; c < XC; ++c) xw[d][c] = a16_load_x(x, M, K, ke, k0 + 16 * c, g);
"""
# the first version: each step summed before the next loads go out
_SUM_FIRST = """      if constexpr (BITS == 4) a16_step_w4(acc, w[d], xw[d]);
      else a16_step_w8(acc, w[d], xw[d]);
      const int k0 = kb + (j0 + (d + GV_DEPTH) * GV_WARPS) * KSTEP + 4 * t;
      a16_load_q<BITS>(q, N, ke, k0, n, w[d]);
#pragma unroll
      for (int c = 0; c < XC; ++c) xw[d][c] = a16_load_x(x, M, K, ke, k0 + 16 * c, g);
"""
_TAIL = """      if constexpr (BITS == 4) {
        // a step past the split's end is all zero: W4 skips its sums (3 %;
        // at W8 that is slower)
        if (j0 + d * GV_WARPS < steps) a16_step_w4(acc, cw, cx);
      } else {
        a16_step_w8(acc, cw, cx);
      }
"""
_W4_SKIP = "        if (j0 + d * GV_WARPS < steps) a16_step_w4(acc, cw, cx);"
_W8_SUM = "        a16_step_w8(acc, cw, cx);"
_LOAD = """      for (int c = 0; c < XC; ++c) xw[d][c] = a16_load_x(x, M, K, ke, k0 + 16 * c, g);
"""
_PLAN = "    return _gemv_plan(N, K, GV_KSTEP4 if bits == 4 else GV_KSTEP)"


def _section(s: str, start: str, end: str):
    a = s.index(start)
    return a, s.index(end, a)


def _warps(n: int):
    """The GEMV's blocks with ``n`` warps (the plan unchanged)."""
    def edit(s):
        a, b = _section(s, "constexpr int GV_KSTEP4", "// Tiled kernel (prefill)")
        body = s[a:b].replace("GV_WARPS", "G16_WARPS")
        s = s[:a] + f"constexpr int G16_WARPS = {n};\n" + body + s[b:]
        a, b = _section(s, "int launch_a16_gemv(", "}  // namespace")
        return s[:a] + s[a:b].replace("GV_WARPS", "G16_WARPS") + s[b:]
    return edit


def _ring(stages: int):
    """Each warp's weight pieces staged through a ring of ``stages`` steps
    in shared memory by 16-byte ``cp.async`` (zero-filled past the split),
    x two steps ahead in registers; the warp sums reuse the ring."""
    def edit(s):
        a, b = _section(s, "template <int BITS>\n__global__ void __launch_bounds__"
                        "(GV_WARPS * 32)\nqmm_a16_gemv",
                        "  // the reduce-scatter of qmm_a8_gemv, on float sums")
        return s[:a] + _RING.replace("@S@", str(stages)) + s[b:]
    return edit


_RING = r'''__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

template <int BITS>
__global__ void __launch_bounds__(GV_WARPS * 32)
qmm_a16_gemv(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int M, int N, int K,
             int k_per_split) {
  constexpr int KSTEP = BITS == 4 ? GV_KSTEP4 : GV_KSTEP;
  constexpr int XC = BITS == 4 ? 2 : 1;
  constexpr int S = @S@;
  __shared__ __align__(16) uint4 ring[GV_WARPS][S][4][32];
  __shared__ float recv[32 * 32 + GV_MAX_SPLITS];
  float(*part)[32 * 32] = reinterpret_cast<float(*)[32 * 32]>(&ring[0][0][0][0]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * GV_BN, n = n0 + 16 * g;
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + KSTEP - 1) / KSTEP;
  const int my = steps > warp ? (steps - warp + GV_WARPS - 1) / GV_WARPS : 0;
  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[p][r] = 0.f;
  auto issue = [&](int i) {
    if (i < my) {
      const int k0 = kb + (warp + i * GV_WARPS) * KSTEP + 4 * t;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = BITS == 4 ? k0 + 2 * (p & 1) + 16 * (p >> 1) : k0 + p;
        const bool in = k < ke && n < N;
        cp_async16z(&ring[warp][i % S][p][lane],
                    in ? q + (size_t)(BITS == 4 ? k >> 1 : k) * N + n : q, in ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  uint2 xc[XC];
#pragma unroll
  for (int c = 0; c < XC; ++c)
    xc[c] = a16_load_x(x, M, K, ke, kb + warp * KSTEP + 16 * c + 4 * t, g);
  for (int i = 0; i < my; ++i) {
    issue(i + S - 1);
    uint2 xn[XC];
    const int k1 = kb + (warp + (i + 1) * GV_WARPS) * KSTEP + 4 * t;
#pragma unroll
    for (int c = 0; c < XC; ++c) xn[c] = a16_load_x(x, M, K, ke, k1 + 16 * c, g);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    uint4 w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p] = ring[warp][i % S][p][lane];
    if constexpr (BITS == 4) a16_step_w4(acc, w, xc);
    else a16_step_w8(acc, w, xc);
#pragma unroll
    for (int c = 0; c < XC; ++c) xc[c] = xn[c];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[warp][(4 * p + r) * 32 + lane] = acc[p][r];
  __syncthreads();
'''

_PREFETCH = _LOAD + """      {
        const int kp = k0 + GV_DEPTH * GV_WARPS * KSTEP;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = BITS == 4 ? kp + 2 * (i & 1) + 16 * (i >> 1) : kp + i;
          if (k < ke && n < N)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                q + (size_t)(BITS == 4 ? k >> 1 : k) * N + n));
        }
      }
"""

_SPLITS4 = """    kstep = GV_KSTEP4 if bits == 4 else GV_KSTEP
    tiles = -(-N // GV_BN)
    steps = -(-K // kstep)
    want = max(1, min(4 if bits == 4 else GV_MAX_SPLITS,
                      -(-_TARGET_BLOCKS // max(tiles, 1)),
                      -(-steps // GV_WARPS)))
    kps = max(1, -(-steps // want)) * kstep
    return GemvPlan((tiles, max(1, -(-K // kps))), kps, 0)"""


def _sub(*pairs):
    """Replace each (old, new) of ``pairs``; None where an old text is
    missing."""
    def edit(s):
        for old, new in pairs:
            if old not in s:
                return None
            s = s.replace(old, new)
        return s
    return edit


# name -> (edit of the kernel source, edit of kernels/quant_matmul.py)
VARIANTS = {
    "first": (_sub((_STEP + _TAIL, _SUM_FIRST)), None),
    "w4_no_skip": (_sub((_W4_SKIP, "        a16_step_w4(acc, cw, cx);")), None),
    "w8_skip": (_sub((_W8_SUM, "        if (j0 + d * GV_WARPS < steps) "
                               "a16_step_w8(acc, cw, cx);")), None),
    "depth3": (_sub(("constexpr int GV_DEPTH = 2;", "constexpr int GV_DEPTH = 3;")),
               None),
    "depth4": (_sub(("constexpr int GV_DEPTH = 2;", "constexpr int GV_DEPTH = 4;")),
               None),
    "warps8": (_warps(8), None),
    "prefetch": (_sub((_LOAD, _PREFETCH)), None),
    "ring3": (_ring(3), None),
    "ring4": (_ring(4), None),
    "w4_splits4": (None, _sub((_PLAN, _SPLITS4))),
}

RUN = r'''
import json, math, sys
sys.path.insert(0, {src!r}); sys.path.insert(1, {root!r})
import torch
import chip_smoke as cs
from repro_torch.kernels import _build, quant_matmul as qm
from repro_torch.quant import ptq
_build.build_all()
out = {{"ptxas": cs.ptxas_lines("quant_matmul", "qmm_a16_gemv"), "bad": []}}
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
with torch.no_grad():
    for bits in (8, 4):
        for K, N in sorted({{(k, n) for _, k, n in cs.LAYER_MATMULS}}):
            w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
            t = ptq.quantize(w, bits)
            x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
            got = qm.quant_matmul_cuda(x, t.q, t.scale.reshape(-1), bits)
            want = qm.quant_matmul_plain(x, t.q, t.scale.reshape(-1), bits)
            if not torch.allclose(got.float(), want.float(), **cs.BF16_TOL):
                out["bad"].append([bits, K, N])
    for tier in ("w8a16", "w4a16"):
        out[tier] = cs.decode_call_ms(tier)
        out[tier + "_bloom7b1"] = cs.decode_call_ms(tier, cs.LAYER_MATMULS_7B1)
print(json.dumps(out))
'''

BUILD = ("import sys\nsys.path.insert(0, {src!r})\n"
         "from repro_torch.kernels import _build\n_build.build_all()\n")


def make(name: str) -> Path | None:
    """The tree of variant ``name`` under build/gemv_variants/, or None
    where its text no longer matches the source."""
    tree = ROOT / "build" / "gemv_variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    dst = tree / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit, rel in zip(VARIANTS[name], (CU, PY)):
        if edit is None:
            continue
        text = (dst / rel).read_text()
        try:
            new = edit(text)
        except ValueError:                  # a section marker is missing
            new = None
        if not new or new == text:
            return None
        (dst / rel).write_text(new)
    return tree


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    trees = {"source": ROOT}
    for name in names:
        tree = make(name)
        if tree is None:
            print(f"{name}: its text no longer matches the source; skipped",
                  flush=True)
        else:
            trees[name] = tree
    builds = [subprocess.Popen([sys.executable, "-c", BUILD.format(
        src=str(t / "src"))]) for t in trees.values()]
    for p in builds:
        p.wait()
    results = {}
    for name in list(trees) + ["source"]:
        r = subprocess.run([sys.executable, "-c", RUN.format(
            src=str(trees[name] / "src"), root=str(ROOT))],
            capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(f"{name}: FAILED\n{r.stderr[-3000:]}", flush=True)
            continue
        out = json.loads(r.stdout.strip().splitlines()[-1])
        layers = {k: sum(v.values()) for k, v in out.items()
                  if k not in ("ptxas", "bad")}
        results.setdefault(name, []).append(dict(out, layer_ms=layers))
        print(f"{name}: layer ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in layers.items())
            + f"; wrong at {out['bad']}; ptxas "
            + " | ".join(line.split(": ", 1)[-1] for line in out["ptxas"]),
            flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

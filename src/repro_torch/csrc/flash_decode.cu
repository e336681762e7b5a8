// One-token GQA decode attention for Hopper (sm_90a), over a slot cache
// (K4) or through a block table over a page arena (K5).
//
// K4 replaces the Pallas TPU kernel _decode_kernel of
// src/repro/kernels/flash_decode.py (wrapper repro/kernels/ops.py
// flash_decode).  q (B, nh, dh) attends over the slot cache k/v
// (B, W, nkv, dh); slots >= n_valid[b] are masked; the G = nh / nkv query
// heads of one kv head share its rows.  Softmax in float32, output divided
// by max(l, 1e-30), in q's type.
//
// K5 replaces _paged_decode_kernel of the same file (wrapper
// repro/kernels/ops.py flash_decode_paged): the same function, where slot
// j of row b lives in page table[b, j / bt] at offset j % bt of the arena
// (P, bt, nkv', dh').  The page, slot and head strides are arguments, so
// the kernel reads the leading (nkv, dh) corner of a wider page tail as
// the strided view it is, without a copy.
//
// What bounds both on an H100: the bytes of the valid cache slots,
// 2 * B * n_valid * nkv * dh * sizeof(T), against 3.35 TB/s; the arithmetic
// is about one multiply-add per byte.  At BLOOM-3B's decode shape (B = 8,
// 576 valid slots, 32 heads of 80, bf16) that is 47 MB, 14 us.
//
// Design.  The TPU walks a row's slots on a sequential grid axis; here the
// slots of a row are cut into splits of SPLIT = 64 logical slots, one block
// of 128 threads per (split, kv head, row), so BLOOM-3B's shape runs 10 x 32
// x 8 blocks (9 x 32 x 8 of them below n_valid) and every SM holds about
// ten blocks' loads in flight.  A block:
//   1. computes its slots' element offsets once (K5: one table load per
//      page run of bt slots, not per element) while n_valid is read;
//   2. copies its K and V rows to shared memory in 16-byte cp.async pieces,
//      all issued at once, V behind K, counted without a divide per piece
//      (a narrower-load instantiation of the same kernel takes views whose
//      strides or bases forbid 16 bytes);
//   3. scores: LG = 4 lanes per slot, each lane over 8-element chunks of
//      d_head, summed by a fixed xor-shuffle tree; the G heads reuse each K
//      row;
//   4. softmax over the split (max, exp, sum in a fixed tree);
//   5. P.V: threads over (head, d chunk) and over interleaved slot groups,
//      the groups summed in index order;
//   6. writes the split's float32 (m, l, acc[G, dh]) to a workspace.
// A second launch merges splits 0 .. ceil(n_valid / SPLIT) - 1 of a row in
// index order, divides by max(l, 1e-30) and rounds once; it is launched
// with programmatic stream serialization, so its blocks are resident when
// the split blocks finish and wait for them (griddepcontrol).  Blocks whose
// split starts at or past n_valid return at once, and the merge reads no
// other split.  The grid depends only on (B, nh, nkv, W, dh), never on
// n_valid's values, which stay on the device.  No atomics take part in any
// sum.  The order of every float sum depends only on (G, dh): not on the
// load width, the type, B, W, other rows or the address functor, so K5
// equals K4 bitwise on the same logical values and a row's output is a
// function of its own q, slots and n_valid.
//
// What holds it above the bound (H100, variants of this kernel built for
// the measurement, PERF.md section 6): its cp.async copies alone take about
// 0.8x the whole split kernel, its arithmetic alone about 0.5x, and the
// merge launch about 2 us of a call.  SPLIT = 64 and 128 threads were the
// fastest of the split sizes and block widths timed there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SPLIT = 64;            // logical slots of one split
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 8;                // d_head elements of one chunk
constexpr int LG = 4;                // lanes of one slot in the score phase
constexpr int SLOTS_PER_PASS = THREADS / LG;
constexpr int SCS = SPLIT + 1;       // score row stride (floats)
constexpr int COMBINE_THREADS = 128;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SPLIT % 32 == 0 && THREADS % 32 == 0, "whole warps");
static_assert(LG >= 2 && LG <= 32 && (LG & (LG - 1)) == 0, "a shuffle tree");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive values of a chunk in shared memory, as float32.
__device__ __forceinline__ void load8(const float* p, float (&x)[CH]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[CH]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// 16-byte cp.async of rows 0 .. n - 1 of P16 pieces each, from src +
// off[j] to the shared tile with a row stride of DPB bytes: thread tid
// takes pieces tid, tid + THREADS, ... in row-major order, counted without
// a divide per piece.
template <typename T>
__device__ __forceinline__ void issue_rows(T* tile, const T* __restrict__ src,
                                           const long long* off, int n,
                                           int P16, int DPB, int tid) {
  int j = tid / P16, c = tid - j * P16;
  const int dj = THREADS / P16, dc = THREADS - dj * P16;
  while (j < n) {
    cp_async16(reinterpret_cast<char*>(tile) + j * DPB + c * 16,
               reinterpret_cast<const char*>(src + off[j]) + c * 16);
    j += dj;
    c += dc;
    if (c >= P16) { c -= P16; ++j; }
  }
}

// The P.V work split: (head, chunk) pairs times interleaved slot groups.
__host__ __device__ inline int pv_groups(int G, int C) {
  return G * C >= THREADS ? 1 : THREADS / (G * C);
}

struct Layout {                      // byte offsets into dynamic shared memory
  size_t off, kt, vt, qs, sc, total;
};

__host__ __device__ inline Layout layout(int G, int dh, int elt) {
  const int C = (dh + CH - 1) / CH, DP = C * CH;
  const size_t tile = (size_t)SPLIT * DP * elt;
  const int ng = pv_groups(G, C);
  const size_t red = ng > 1 ? (size_t)ng * G * C * CH * sizeof(float) : 0;
  Layout L;
  L.off = 0;                                        // SPLIT long long
  L.kt = (size_t)SPLIT * sizeof(long long);
  L.vt = L.kt + ((tile > red ? tile : red) + 15) / 16 * 16;   // red aliases kt
  L.qs = L.vt + (tile + 15) / 16 * 16;              // (G, DP) float
  L.sc = L.qs + (size_t)G * DP * sizeof(float);
  L.total = L.sc + (size_t)G * SCS * sizeof(float); // (G, SCS) float
  return L;
}

// Element offsets of (row b, logical slots s0 .. s0 + n - 1, kv head h,
// d = 0) in k and v, written to off[0 .. n).
// K4: a contiguous slab (B, W, nkv, dh).
struct SlabAddr {
  int W, nkv, dh;
  __device__ __forceinline__ void fill(long long* off, int b, int s0, int n,
                                       int h, int tid) const {
    for (int t = tid; t < n; t += THREADS)
      off[t] = (((long long)b * W + s0 + t) * nkv + h) * dh;
  }
};

// K5: page table[b, s / bt], offset s % bt, of a strided page arena whose
// d_head axis is contiguous.  One thread per page run: one table load and
// one base address per bt slots.
struct PagedAddr {
  const int* table;                  // (B, n_b) int32
  int n_b, bt;
  long long page_stride, slot_stride, head_stride;
  __device__ __forceinline__ void fill(long long* off, int b, int s0, int n,
                                       int h, int tid) const {
    const int blk0 = s0 / bt, nblk = (s0 + n - 1) / bt - blk0 + 1;
    for (int i = tid; i < nblk; i += THREADS) {
      const int blk = blk0 + i, first = blk * bt;
      const long long base = (long long)table[(size_t)b * n_b + blk] * page_stride
                           + (long long)h * head_stride;
      const int lo = max(s0, first), hi = min(s0 + n, first + bt);
      for (int s = lo; s < hi; ++s)
        off[s - s0] = base + (long long)(s - first) * slot_stride;
    }
  }
};

// One split of one (row, kv head): partial (m, l, acc) of its G heads.
// WIDE: 16-byte cp.async loads (dh % 8 == 0, 16-byte aligned rows);
// otherwise element loads into the same shared-memory layout, so the
// arithmetic that follows is the same.
template <typename T, bool WIDE, typename Addr>
__global__ void __launch_bounds__(THREADS)
fd_split(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ n_valid,
         int nv_scalar, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
         int nh, int nkv, int W, int dh, float scale, Addr addr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = nh / nkv, C = (dh + CH - 1) / CH, DP = C * CH;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = split * SPLIT;
  const Layout L = layout(G, dh, (int)sizeof(T));
  long long* off = reinterpret_cast<long long*>(smem + L.off);
  T* kt = reinterpret_cast<T*>(smem + L.kt);        // (SPLIT, DP)
  T* vt = reinterpret_cast<T*>(smem + L.vt);        // (SPLIT, DP)
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);

  // the offsets of the split's slots below W, while n_valid is read
  int nv = n_valid ? n_valid[b] : nv_scalar;
  addr.fill(off, b, s0, min(SPLIT, W - s0), h, tid);
  // the merge may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  nv = min(nv, W);
  if (s0 >= nv) return;
  const int n = min(SPLIT, nv - s0);
  __syncthreads();                                  // the offsets are shared

  // K, then V, all in flight at once
  if (WIDE) {
    const int P16 = DP * (int)sizeof(T) / 16, DPB = DP * (int)sizeof(T);
    issue_rows(kt, k, off, n, P16, DPB, tid);
    cp_async_commit();
    issue_rows(vt, v, off, n, P16, DPB, tid);
    cp_async_commit();
  } else {
    const T zero = from_f32<T>(0.f);
    for (int i = tid; i < n * DP; i += THREADS) {
      const int j = i / DP, d = i - j * DP;
      kt[i] = d < dh ? k[off[j] + d] : zero;
      vt[i] = d < dh ? v[off[j] + d] : zero;
    }
  }
  // q, while the rows are in flight
  const T* qb = q + ((size_t)b * nh + (size_t)h * G) * dh;
  for (int i = tid; i < G * DP; i += THREADS) {
    const int g = i / DP, d = i - g * DP;
    qs[i] = d < dh ? to_f32(qb[(size_t)g * dh + d]) * scale : 0.f;
  }
  if (WIDE) cp_async_wait<1>();                     // K has landed
  __syncthreads();

  // scores: slot j0 + tid / LG, its LG lanes over chunks, a fixed xor tree
  const int grp = tid / LG, lq = tid % LG;
  for (int j0 = 0; j0 < n; j0 += SLOTS_PER_PASS) {
    const int j = j0 + grp;
    const bool live = j < n;
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
      if (live) {
        for (int c = lq; c < C; c += LG) {
          float kx[CH], qx[CH];
          load8(kt + (size_t)j * DP + c * CH, kx);
          load8(qs + g * DP + c * CH, qx);
#pragma unroll
          for (int e = 0; e < CH; ++e) part = fmaf(qx[e], kx[e], part);
        }
      }
#pragma unroll
      for (int o = LG / 2; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      if (live && lq == 0) sc[g * SCS + j] = part;
    }
  }
  __syncthreads();

  // softmax over the split's valid slots, one warp per head
  const size_t row0 = ((size_t)b * nh + (size_t)h * G) * NS + split;
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[g * SCS + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sc[g * SCS + j] - mx);
      sc[g * SCS + j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      ws_ml[(row0 + (size_t)g * NS) * 2] = mx;
      ws_ml[(row0 + (size_t)g * NS) * 2 + 1] = sum;
    }
  }
  if (WIDE) cp_async_wait<0>();                     // V has landed
  __syncthreads();

  // P.V: pair (g, c) in slot group k sums slots k, k + NG, ... in order;
  // the groups are then summed in index order
  const int NP = G * C, NG = pv_groups(G, C);
  float* red = reinterpret_cast<float*>(kt);        // K is read no more
  for (int w = tid; w < NG * NP; w += THREADS) {
    const int kg = w / NP, pr = w - kg * NP, g = pr / C, c = pr - g * C;
    float a[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) a[e] = 0.f;
    for (int j = kg; j < n; j += NG) {
      const float p = sc[g * SCS + j];
      float vx[CH];
      load8(vt + (size_t)j * DP + c * CH, vx);
#pragma unroll
      for (int e = 0; e < CH; ++e) a[e] = fmaf(p, vx[e], a[e]);
    }
    if (NG == 1) {
      float* dst = ws_acc + (row0 + (size_t)g * NS) * dh + c * CH;
#pragma unroll
      for (int e = 0; e < CH; ++e)
        if (c * CH + e < dh) dst[e] = a[e];
    } else {
      float4* r = reinterpret_cast<float4*>(red + (size_t)w * CH);
      r[0] = make_float4(a[0], a[1], a[2], a[3]);
      r[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
  }
  if (NG > 1) {                                     // groups, in index order
    __syncthreads();
    for (int t = tid; t < NP * CH; t += THREADS) {
      const int pr = t / CH, g = pr / C, d = (pr - g * C) * CH + t % CH;
      float x = red[t];
      for (int kg = 1; kg < NG; ++kg) x += red[(size_t)kg * NP * CH + t];
      if (d < dh) ws_acc[(row0 + (size_t)g * NS) * dh + d] = x;
    }
  }
}

// Merge the splits of one (row, query head) in index order: the running
// maxima and denominators of all splits are staged in shared memory in one
// round trip, then each thread sums its d_head elements over the splits.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
fd_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
           const int* __restrict__ n_valid, int nv_scalar, T* __restrict__ out,
           int nh, int W, int dh) {
  extern __shared__ float mls[];                    // (ns, 2)
  const int hq = blockIdx.x, b = blockIdx.y;
  const int NS = (W + SPLIT - 1) / SPLIT;
  int nv = n_valid ? n_valid[b] : nv_scalar;        // fd_split does not write it
  nv = min(nv, W);
  const int ns = nv > 0 ? (nv + SPLIT - 1) / SPLIT : 0;
  const size_t row = ((size_t)b * nh + hq) * NS;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // fd_split is done
  for (int i = threadIdx.x; i < 2 * ns; i += COMBINE_THREADS)
    mls[i] = ws_ml[row * 2 + i];
  __syncthreads();
  float mx = NEG;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, mls[2 * s]);
  for (int d = threadIdx.x; d < dh; d += COMBINE_THREADS) {
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float w = expf(mls[2 * s] - mx);
      l = fmaf(w, mls[2 * s + 1], l);
      a = fmaf(w, ws_acc[(row + s) * dh + d], a);
    }
    out[((size_t)b * nh + hq) * dh + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool WIDE, typename Addr>
int launch(const void* q, const void* k, const void* v, const int* n_valid,
           int nv_scalar, void* out, void* ws, int B, int nh, int nkv, int W,
           int dh, float scale, Addr addr, cudaStream_t stream) {
  const int G = nh / nkv, NS = (W + SPLIT - 1) / SPLIT;
  const size_t bytes = layout(G, dh, (int)sizeof(T)).total;
  static size_t granted = 48 * 1024;                // per instantiation
  if (bytes > granted) {
    cudaError_t e = cudaFuncSetAttribute(fd_split<T, WIDE, Addr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  static bool carveout = false;                     // cp.async.cg skips L1
  if (!carveout) {
    cudaError_t e = cudaFuncSetAttribute(fd_split<T, WIDE, Addr>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    carveout = true;
  }
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)B * nh * NS * dh;
  fd_split<T, WIDE, Addr><<<dim3(NS, nkv, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      n_valid, nv_scalar, ws_acc, ws_ml, nh, nkv, W, dh, scale, addr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the merge, launched to start as the split blocks finish
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh, B);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.dynamicSmemBytes = (size_t)2 * NS * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fd_combine<T>, (const float*)ws_acc,
                         (const float*)ws_ml, n_valid, nv_scalar,
                         static_cast<T*>(out), nh, W, dh);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Addr>
int dispatch(int bf16, int wide, const void* q, const void* k, const void* v,
             const int* n_valid, int nv_scalar, void* out, void* ws, int B,
             int nh, int nkv, int W, int dh, float scale, Addr addr,
             cudaStream_t st) {
  if (bf16)
    return wide ? launch<__nv_bfloat16, true>(q, k, v, n_valid, nv_scalar, out, ws, B, nh, nkv, W, dh, scale, addr, st)
                : launch<__nv_bfloat16, false>(q, k, v, n_valid, nv_scalar, out, ws, B, nh, nkv, W, dh, scale, addr, st);
  return wide ? launch<float, true>(q, k, v, n_valid, nv_scalar, out, ws, B, nh, nkv, W, dh, scale, addr, st)
              : launch<float, false>(q, k, v, n_valid, nv_scalar, out, ws, B, nh, nkv, W, dh, scale, addr, st);
}

}  // namespace

extern "C" {

// q (B, nh, dh), k/v (B, W, nkv, dh), out (B, nh, dh): float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), contiguous.  n_valid: (B,) int32 device pointer,
// or null to use nv_scalar for every row.  scale: the logits' factor
// (1/sqrt(dh), or a model's own), applied to q.  ws: B * nh *
// ceil(W / SPLIT) * (dh + 2) float32 of scratch.  wide: 16-byte loads
// (dh % 8 == 0 and k, v 16-byte aligned).
int flash_decode(const void* q, const void* k, const void* v,
                 const void* n_valid, int nv_scalar, void* out, void* ws,
                 int B, int nh, int nkv, int W, int dh, float scale, int bf16,
                 int wide, void* stream) {
  const SlabAddr addr{W, nkv, dh};
  return dispatch(bf16, wide, q, k, v, static_cast<const int*>(n_valid),
                  nv_scalar, out, ws, B, nh, nkv, W, dh, scale, addr,
                  static_cast<cudaStream_t>(stream));
}

// q (B, nh, dh), out (B, nh, dh) contiguous; k/v: page arenas of one layer
// with element strides page_stride, slot_stride, head_stride and a
// contiguous d_head axis (a leading-corner view of a wider tail is fine);
// table (B, n_b) int32 of page ids; n_valid as for flash_decode, at most
// n_b * bt; ws as for flash_decode with W = n_b * bt.  wide: 16-byte loads
// (dh % 8 == 0, 16-byte aligned bases and strides).  k and v share their
// strides.
int flash_decode_paged(const void* q, const void* k, const void* v,
                       const void* table, const void* n_valid, int nv_scalar,
                       void* out, void* ws, int B, int nh, int nkv, int n_b,
                       int bt, int dh, long long page_stride,
                       long long slot_stride, long long head_stride,
                       float scale, int bf16, int wide, void* stream) {
  const PagedAddr addr{static_cast<const int*>(table), n_b, bt, page_stride,
                       slot_stride, head_stride};
  return dispatch(bf16, wide, q, k, v, static_cast<const int*>(n_valid),
                  nv_scalar, out, ws, B, nh, nkv, n_b * bt, dh, scale, addr,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

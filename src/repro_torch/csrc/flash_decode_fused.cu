// Fused quantized decode attention for Hopper (sm_90a), over a slot cache
// (K6) or through a block table over a page arena (K7).
//
// K6 replaces the Pallas TPU kernel _fused_body (with _qproject and
// _rot_half) of src/repro/kernels/flash_decode.py, wrapper
// repro/kernels/ops.py flash_decode_fused; K7 replaces _fused_paged_body
// (wrapper flash_decode_fused_paged).  One decode-attention step from the
// hidden row x (B, D) and the int8 projections wq (D, nh*dh), wk/wv
// (D, nkv*dh), wo (nh*dh, D), each with a float32 scale per column:
//
//   1. project q (the G = nh / nkv heads of one KV head), k1 and v1 from x.
//      a16: sum_d x[d] * (w[d, c] * s[c]) in float32.  a8: x is quantized
//      per row (sx = absmax * float32(1/127), x / sx rounded half to even,
//      clipped to [-128, 127]), summed exactly in int32 and rescaled once,
//      acc * sx * s[c];
//   2. rotate q and k1 by the rope rows cos/sin (1, dh/2), split halves;
//   3. online softmax in float32 over the PRE-write cache: slots >=
//      n_valid[b] and the slot evict[b] (the one the current token will
//      overwrite once the window has wrapped; -1: none) are masked;
//   4. the current token (its float32 k1/v1) folded in as the last step,
//      then attn = acc / max(l, 1e-30);
//   5. the head group's attn (G * dh; a8: quantized as ONE row of G * dh,
//      as the TPU kernel does) through its wo tile into a float32 partial
//      o_h (D,).
//
// k1/v1 are written in x's type; the caller writes them into the cache.
// The TPU grid sums the partials into its output block across the KV-head
// axis, in x's type: o = T(o_0); o = T(o + T(o_h)) for h = 1, 2, ....  Here
// blocks run in no order, so each (b, h) block writes its partial and a
// second small kernel sums them in that same order: deterministic, no
// atomics.  One call of the tier is these two launches.
//
// K7 is the same body templated on a block-table address functor, as K5 is
// K4's (csrc/flash_decode.cu): slot s of row b lives in page
// table[b, s / bt] at offset s % bt, with page, slot and head strides as
// arguments, so the leading (nkv, dh) corner of a wider page tail is read
// in place.  Each tile's slot offsets are computed once per tile (one
// divide per slot, not per element) into shared memory; the slab functor
// goes through the same code, so K7 equals K6 bitwise on the same values.
//
// What bounds it on an H100: the bytes, 4 int8 projection matrices plus
// the cache slots read, 2 * B * n_valid * nkv * dh * sizeof(T), against
// 3.35 TB/s (BLOOM-7B1, B = 8, 576 slots: about 143 MB, 0.043 ms).  This
// first version gives each (row, KV head) a block, like the TPU grid: the
// B blocks of one head read the same weight tiles, adjacent in launch order
// (blockIdx.x is the row) so that the repeats come from L2, but each layer's
// int8 weights still cross from L2 to the SMs B times.  Weights are read
// 16 bytes a lane when the widths allow it.  The cache tile loop is K4's
// (64-slot tiles in shared memory as float32, fixed-order sums); it stops at
// n_valid, so at pos 0 it runs no tile and the masked running max stays at
// -1e30, which the current token's step then washes out (alpha = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;          // cache slots per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

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

__host__ __device__ inline int row_stride(int dh) { return (dh % 2 == 0) ? dh + 1 : dh; }

// Shared memory, in 4-byte words: x (D) | q (G*dh) | k1, v1 (dh each) |
// acc (G*dh) | m, l, alpha (G each) | work | int8 rows
// (D for x, G*dh for attn).  work holds either a projection's partial sums
// (THREADS * VEC words) or the cache tiles, their scores and the tile's
// slot offsets.
__host__ __device__ inline size_t work_words(int G, int dh, int vec) {
  const size_t red = (size_t)THREADS * vec;
  // + the tile's BS 8-byte slot offsets, 8-byte aligned
  const size_t tiles = (size_t)2 * BS * row_stride(dh) + (size_t)G * BS + 2 * BS + 1;
  return red > tiles ? red : tiles;
}
__host__ __device__ inline size_t smem_words(int D, int G, int dh, int vec) {
  return (size_t)D + 2 * (size_t)G * dh + 2 * (size_t)dh + 3 * (size_t)G
       + work_words(G, dh, vec) + ((size_t)D + (size_t)G * dh + 3) / 4;
}

// Element offset of (row b, logical slot s, kv head h, d = 0) in k and v.
// K6: a contiguous slab (B, W, nkv, dh).
struct SlabAddr {
  int W, nkv, dh;
  __device__ __forceinline__ long long operator()(int b, int s, int h) const {
    return (((long long)b * W + s) * nkv + h) * dh;
  }
};

// K7: page table[b, s / bt], offset s % bt, of a strided page arena whose
// d_head axis is contiguous.
struct PagedAddr {
  const int* table;                // (B, n_b) int32
  int n_b, bt;
  long long page_stride, slot_stride, head_stride;
  __device__ __forceinline__ long long operator()(int b, int s, int h) const {
    const int page = table[(long long)b * n_b + s / bt];
    return (long long)page * page_stride + (long long)(s % bt) * slot_stride
         + (long long)h * head_stride;
  }
};

// VEC consecutive int8 weights, sign-extended.
template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 16) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    const int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = (int)(signed char)((words[i / 4] >> (8 * (i % 4))) & 0xff);
  } else {
    const char2 r = *reinterpret_cast<const char2*>(p);
    v[0] = r.x;
    v[1] = r.y;
  }
}

// Block-wide max of |v[i]| over n values in shared memory (exact, any order).
__device__ float block_absmax(const float* v, int n, float* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx = 0.f;
  for (int i = tid; i < n; i += THREADS) mx = fmaxf(mx, fabsf(v[i]));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) scratch[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, scratch[w]);
    scratch[WARPS] = m;
  }
  __syncthreads();
  const float r = scratch[WARPS];
  __syncthreads();
  return r;
}

// Row quantization of v (n values): returns sx; q[i] = clip(rint(v / sx)).
__device__ float quantize_row(const float* v, int n, int8_t* q, float inv127,
                              float* scratch) {
  const float amax = block_absmax(v, n, scratch);
  const float sx = amax > 0.f ? __fmul_rn(amax, inv127) : 1.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float r = rintf(__fdiv_rn(v[i], sx));
    q[i] = (int8_t)(int)fminf(fmaxf(r, -128.f), 127.f);
  }
  __syncthreads();
  return sx;
}

// out[c] for c in [0, C): the column window [c0, c0 + C) of the row-major
// int8 matrix w (Din, N) projected from the shared-memory row (xf in
// float32, or xq in int8 with its scale sx), times the column scales
// s[c0 + c].  Threads split the rows: TPC threads cover a chunk of columns
// VEC at a time, R = THREADS / TPC row groups each take every R-th row, and
// the R partial sums of a column are added in row-group order.  The result
// goes to shared memory (out_s) or to global memory (out_g).
template <int VEC, bool A8>
__device__ void project(const int8_t* __restrict__ w, int N, int c0, int C,
                        int Din, const float* xf, const int8_t* xq, float sx,
                        const float* __restrict__ s, float* red, float* out_s,
                        float* __restrict__ out_g) {
  const int tid = threadIdx.x;
  const int TPC = min(C / VEC, THREADS);
  const int R = THREADS / TPC, CW = TPC * VEC;
  const int cg = tid % TPC, r = tid / TPC;
  for (int cc = 0; cc < C; cc += CW) {
    const int col = cc + cg * VEC;
    if (r < R && col < C) {
      float facc[VEC];
      int iacc[VEC];
      float sc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        facc[i] = 0.f;
        iacc[i] = 0;
        sc[i] = A8 ? 0.f : s[c0 + col + i];
      }
      const int8_t* wp = w + (long long)c0 + col;
#pragma unroll 4
      for (int d = r; d < Din; d += R) {
        int wv[VEC];
        load_i8<VEC>(wp + (long long)d * N, wv);
        if constexpr (A8) {
          const int xv = xq[d];
#pragma unroll
          for (int i = 0; i < VEC; ++i) iacc[i] += xv * wv[i];
        } else {
          const float xv = xf[d];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            facc[i] = fmaf(xv, __fmul_rn((float)wv[i], sc[i]), facc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[r * CW + cg * VEC + i] = A8 ? __int_as_float(iacc[i]) : facc[i];
    }
    __syncthreads();
    const int cw = min(CW, C - cc);
    for (int c = tid; c < cw; c += THREADS) {
      float v;
      if constexpr (A8) {
        int a = 0;
        for (int rr = 0; rr < R; ++rr) a += __float_as_int(red[rr * CW + c]);
        v = __fmul_rn(__fmul_rn((float)a, sx), s[c0 + cc + c]);
      } else {
        v = 0.f;
        for (int rr = 0; rr < R; ++rr) v += red[rr * CW + c];
      }
      if (out_s) out_s[cc + c] = v;
      else out_g[cc + c] = v;
    }
    __syncthreads();
  }
}

// Split-halves rope on `rows` rows of dh values in shared memory.
__device__ void rope_rows(float* t, int rows, int dh, const float* __restrict__ cs,
                          const float* __restrict__ sn) {
  const int half = dh / 2;
  for (int i = threadIdx.x; i < rows * half; i += THREADS) {
    const int g = i / half, j = i % half;
    const float t1 = t[g * dh + j], t2 = t[g * dh + half + j];
    const float c = cs[j], s = sn[j];
    t[g * dh + j] = t1 * c - t2 * s;
    t[g * dh + half + j] = t1 * s + t2 * c;
  }
  __syncthreads();
}

struct FusedArgs {
  const void *x, *wq, *sq, *wk, *sk, *wv, *sv, *wo, *so, *k, *v;
  const int *n_valid, *evict;
  int nv_scalar, ev_scalar;
  const float *cos, *sin;
  void *k1, *v1;
  float* part;                       // (B, nkv, D) float32
  int D, nh, nkv, dh, W;
  float scale, inv127;
  int use_rope;
};

template <typename T, bool A8, int VEC, typename Addr>
__global__ void __launch_bounds__(THREADS)
fused_decode_kernel(FusedArgs a, Addr addr) {
  extern __shared__ float smem[];
  const int D = a.D, dh = a.dh, nkv = a.nkv;
  const int G = a.nh / nkv, ds = row_stride(dh), Gd = G * dh;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = smem;                 // (D,)
  float* qs = xs + D;               // (G, dh), then pre-scaled
  float* k1s = qs + Gd;             // (dh,)
  float* v1s = k1s + dh;            // (dh,)
  float* acc = v1s + dh;            // (G, dh), then attn
  float* m = acc + Gd;              // (G,)
  float* l = m + G;
  float* alpha = l + G;
  float* work = alpha + G;
  int8_t* xq = reinterpret_cast<int8_t*>(work + work_words(G, dh, VEC));  // (D,)
  int8_t* aq = xq + D;              // (G * dh,)
  float* red = work;
  float* ks = work;                 // (BS, ds)
  float* vs = ks + BS * ds;         // (BS, ds)
  float* sc = vs + BS * ds;         // (G, BS)
  long long* base = reinterpret_cast<long long*>(   // (BS,) slot offsets
      (reinterpret_cast<uintptr_t>(sc + G * BS) + 7) & ~(uintptr_t)7);

  const T* x = static_cast<const T*>(a.x) + (long long)b * D;
  for (int i = tid; i < D; i += THREADS) xs[i] = to_f32(x[i]);
  __syncthreads();
  float sxr = 1.f;
  if constexpr (A8) sxr = quantize_row(xs, D, xq, a.inv127, work);

  // 1. projections of this head group
  const int8_t* wq = static_cast<const int8_t*>(a.wq);
  const int8_t* wk = static_cast<const int8_t*>(a.wk);
  const int8_t* wv = static_cast<const int8_t*>(a.wv);
  const int8_t* wo = static_cast<const int8_t*>(a.wo);
  project<VEC, A8>(wq, a.nh * dh, h * Gd, Gd, D, xs, xq, sxr,
                   static_cast<const float*>(a.sq), red, qs, nullptr);
  project<VEC, A8>(wk, nkv * dh, h * dh, dh, D, xs, xq, sxr,
                   static_cast<const float*>(a.sk), red, k1s, nullptr);
  project<VEC, A8>(wv, nkv * dh, h * dh, dh, D, xs, xq, sxr,
                   static_cast<const float*>(a.sv), red, v1s, nullptr);
  // 2. rope on q and k1; k1/v1 out in x's type
  if (a.use_rope) {
    rope_rows(qs, G, dh, a.cos, a.sin);
    rope_rows(k1s, 1, dh, a.cos, a.sin);
  }
  const long long kvo = ((long long)b * nkv + h) * dh;
  for (int i = tid; i < dh; i += THREADS) {
    static_cast<T*>(a.k1)[kvo + i] = from_f32<T>(k1s[i]);
    static_cast<T*>(a.v1)[kvo + i] = from_f32<T>(v1s[i]);
  }
  for (int i = tid; i < Gd; i += THREADS) {
    qs[i] *= a.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) { m[g] = NEG; l[g] = 0.f; }
  __syncthreads();

  // 3. online softmax over the pre-write cache
  int nv = a.n_valid ? a.n_valid[b] : a.nv_scalar;
  nv = max(0, min(nv, a.W));
  const int ev = a.evict ? a.evict[b] : a.ev_scalar;
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  for (int s0 = 0; s0 < nv; s0 += BS) {
    const int bs = min(BS, nv - s0);
    for (int j = tid; j < bs; j += THREADS) base[j] = addr(b, s0 + j, h);
    __syncthreads();
    for (int j = warp; j < bs; j += WARPS) {
      const long long src = base[j];
      for (int d = lane; d < dh; d += 32) {
        ks[j * ds + d] = to_f32(kc[src + d]);
        vs[j * ds + d] = to_f32(vc[src + d]);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * BS; i += THREADS) {
      const int g = i / BS, j = i % BS;
      float s = NEG;
      if (j < bs && s0 + j != ev) {
        s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(qs[g * dh + d], ks[j * ds + d], s);
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG;
      for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, sc[g * BS + j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const bool ok = j < bs && s0 + j != ev;
        const float p = ok ? expf(sc[g * BS + j] - m_new) : 0.f;
        sc[g * BS + j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = expf(m[g] - m_new);
        alpha[g] = al;
        l[g] = al * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < Gd; i += THREADS) {
      const int g = i / dh, d = i % dh;
      float o = acc[i] * alpha[g];
      for (int j = 0; j < bs; ++j) o = fmaf(sc[g * BS + j], vs[j * ds + d], o);
      acc[i] = o;
    }
    __syncthreads();
  }

  // 4. the current token as the last step, then normalize
  for (int g = warp; g < G; g += WARPS) {
    float s = 0.f;
    for (int d = lane; d < dh; d += 32) s = fmaf(qs[g * dh + d], k1s[d], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float m_fin = fmaxf(m[g], s);
      const float p = expf(s - m_fin);
      const float al = expf(m[g] - m_fin);
      alpha[g] = al;
      m[g] = p;                      // reused: the current token's weight
      l[g] = al * l[g] + p;
    }
  }
  __syncthreads();
  for (int i = tid; i < Gd; i += THREADS) {
    const int g = i / dh, d = i % dh;
    const float o = acc[i] * alpha[g] + m[g] * v1s[d];
    acc[i] = o / fmaxf(l[g], 1e-30f);
  }
  __syncthreads();

  // 5. the head group through its wo tile into this block's partial
  float sxa = 1.f;
  if constexpr (A8) sxa = quantize_row(acc, Gd, aq, a.inv127, work);
  project<VEC, A8>(wo + (long long)h * Gd * D, D, 0, D, Gd, acc, aq, sxa,
                   static_cast<const float*>(a.so), red, nullptr,
                   a.part + ((long long)b * nkv + h) * D);
}

// o[b, c] = T(part[b, 0, c]), then o = T(o + T(part[b, h, c])) in head order.
template <typename T>
__global__ void sum_heads_kernel(const float* __restrict__ part, T* __restrict__ out,
                                 int B, int nkv, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * D) return;
  const long long b = i / D, c = i % D;
  const float* p = part + b * nkv * D + c;
  T o = from_f32<T>(p[0]);
  for (int h = 1; h < nkv; ++h)
    o = from_f32<T>(to_f32(o) + to_f32(from_f32<T>(p[(long long)h * D])));
  out[i] = o;
}

template <typename T, bool A8, int VEC, typename Addr>
int launch_t(const FusedArgs& a, void* out, int B, Addr addr, cudaStream_t st) {
  const int G = a.nh / a.nkv;
  const size_t bytes = smem_words(a.D, G, a.dh, VEC) * 4;
  auto kern = fused_decode_kernel<T, A8, VEC, Addr>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, a.nkv), THREADS, bytes, st>>>(a, addr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * a.D;
  sum_heads_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<T*>(out), B, a.nkv, a.D);
  return (int)cudaGetLastError();
}

template <typename Addr>
int launch(const FusedArgs& a, void* out, int B, int bf16, int a8, int vec,
           Addr addr, cudaStream_t st) {
  if (vec != 16 && vec != 2) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (a8) return vec == 16 ? launch_t<__nv_bfloat16, true, 16>(a, out, B, addr, st)
                             : launch_t<__nv_bfloat16, true, 2>(a, out, B, addr, st);
    return vec == 16 ? launch_t<__nv_bfloat16, false, 16>(a, out, B, addr, st)
                     : launch_t<__nv_bfloat16, false, 2>(a, out, B, addr, st);
  }
  if (a8) return vec == 16 ? launch_t<float, true, 16>(a, out, B, addr, st)
                           : launch_t<float, true, 2>(a, out, B, addr, st);
  return vec == 16 ? launch_t<float, false, 16>(a, out, B, addr, st)
                   : launch_t<float, false, 2>(a, out, B, addr, st);
}

}  // namespace

extern "C" {

// x (B, D), out (B, D), k1/v1 (B, nkv, dh): float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous.  wq (D, nh*dh), wk/wv (D, nkv*dh), wo (nh*dh, D)
// int8 and their float32 column scales, contiguous; with vec = 16 every
// width is a multiple of 16 and every weight 16-byte aligned, with vec = 2
// dh and D are even.  k/v (B, W, nkv, dh) in x's type, contiguous.
// n_valid / evict: (B,) int32 device pointers, or null to use the scalar
// for every row.  cos/sin: (dh/2,) float32.  part: (B, nkv, D) float32
// scratch.  scale = 1/sqrt(dh); inv127 = float32(1/127).
int flash_decode_fused(const void* x, const void* wq, const void* sq,
                       const void* wk, const void* sk, const void* wv,
                       const void* sv, const void* wo, const void* so,
                       const void* k, const void* v, const void* n_valid,
                       int nv_scalar, const void* evict, int ev_scalar,
                       const void* cos, const void* sin, void* out, void* k1,
                       void* v1, void* part, int B, int D, int nh, int nkv,
                       int dh, int W, float scale, float inv127, int use_rope,
                       int a8, int bf16, int vec, void* stream) {
  const FusedArgs a{x, wq, sq, wk, sk, wv, sv, wo, so, k, v,
                    static_cast<const int*>(n_valid), static_cast<const int*>(evict),
                    nv_scalar, ev_scalar, static_cast<const float*>(cos),
                    static_cast<const float*>(sin), k1, v1, static_cast<float*>(part),
                    D, nh, nkv, dh, W, scale, inv127, use_rope};
  return launch(a, out, B, bf16, a8, vec, SlabAddr{W, nkv, dh},
                static_cast<cudaStream_t>(stream));
}

// As flash_decode_fused, with k/v the page arenas of one layer (element
// strides page_stride, slot_stride, head_stride, a contiguous d_head axis;
// k and v share their strides) read through table (B, n_b) int32 of page
// ids, W = n_b * bt.
int flash_decode_fused_paged(const void* x, const void* wq, const void* sq,
                             const void* wk, const void* sk, const void* wv,
                             const void* sv, const void* wo, const void* so,
                             const void* k, const void* v, const void* table,
                             const void* n_valid, int nv_scalar,
                             const void* evict, int ev_scalar, const void* cos,
                             const void* sin, void* out, void* k1, void* v1,
                             void* part, int B, int D, int nh, int nkv, int dh,
                             int n_b, int bt, long long page_stride,
                             long long slot_stride, long long head_stride,
                             float scale, float inv127, int use_rope, int a8,
                             int bf16, int vec, void* stream) {
  const FusedArgs a{x, wq, sq, wk, sk, wv, sv, wo, so, k, v,
                    static_cast<const int*>(n_valid), static_cast<const int*>(evict),
                    nv_scalar, ev_scalar, static_cast<const float*>(cos),
                    static_cast<const float*>(sin), k1, v1, static_cast<float*>(part),
                    D, nh, nkv, dh, n_b * bt, scale, inv127, use_rope};
  const PagedAddr addr{static_cast<const int*>(table), n_b, bt, page_stride,
                       slot_stride, head_stride};
  return launch(a, out, B, bf16, a8, vec, addr, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// The elementwise chains of a transformer decode layer for Hopper
// (sm_90a): the residual add with the next norm (add_norm), and rope on q
// and k with the token's cache write (rope_qk_write).
//
// Neither replaces a Pallas kernel: in the JAX package XLA fuses these
// chains (src/repro/models/common.py: apply_norm, apply_rope; the cache
// writes of decode_attention and decode_attention_paged).  Run as PyTorch
// ops, one decode layer took about 60 kernels for them, each of them a
// launch with its ramp-up and tail on a few kilobytes; these two kernels
// take 3 launches a layer (2 add_norm, 1 rope_qk_write).
//
// add_norm.  x, y (rows, D), w (D) or none; one block per row.  The row's
// x_new = T(x + y) (a float32 add rounded once, as PyTorch adds two bf16
// tensors) is written once and kept in registers, and h = T(norm(x_new))
// is computed in float32 from the rounded values with apply_norm's
// operations in its order:
//   layernorm: mu = mean(x), var = mean((x - mu)^2),
//              h = (x - mu) * rsqrt(var + eps) [* w]
//   rmsnorm:   h = x * rsqrt(mean(x * x) + eps) [* w]
// Each mean is a fixed-order block sum: a thread's elements in index
// order, an xor-shuffle tree in the warp, the warps in order; no atomics,
// so a row's result does not depend on the other rows or the run.  With y
// absent x_new is x and is not written.
//
// rope_qk_write.  q (B, nh, dh), k, v (B, nkv, dh): one decode token's
// projections.  One thread per (row, head, pair i < dh/2) of q, k and v:
// q and k are rotated in float32 by the split-halves formula of
// apply_rope, (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos) with cos and
// sin of float(pos) * freqs[i] (precise cosf / sinf; the products and sums
// rounded one by one, never contracted to an fma, as PyTorch's separate
// ops round them); the rotated q goes to q_out, the rotated k and the
// plain v into the cache: slot pos % W of a slab (B, W, nkv, dh), or page
// table[b, pos / bt] at offset pos % bt of an arena view with element
// strides (page, slot, head) and a contiguous d_head axis.  pos is read on
// the device (a captured step replays at whatever position it holds), or
// given as a scalar.
//
// What bounds them: bytes, and they move few.  add_norm at B = 8, D =
// 2560, bf16 reads 82 KB and writes 82 KB (0.05 us at 3.35 TB/s);
// rope_qk_write at BLOOM-3B's 32 x 80 moves 123 KB.  Both are launch and
// latency bound on the card: a few microseconds each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int ROPE_THREADS = 256;

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

// The block's sum of one value per thread in a fixed order: an xor
// shuffle tree within each warp (every lane ends with the same bits), then
// warp 0 over the warps' sums in warp order.  red: 33 floats of shared
// memory, free on entry.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();                   // red is free again
  return total;
}

// RMS: rmsnorm; otherwise layernorm.  PER: elements a thread holds (D <=
// PER * blockDim.x); element i of the row is thread i % blockDim.x's
// number i / blockDim.x.
template <typename T, bool RMS, int PER>
__global__ void __launch_bounds__(MAX_THREADS)
add_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ w, T* __restrict__ x_out,
                T* __restrict__ h, int D, float eps) {
  __shared__ float red[33];
  const long long base = (long long)blockIdx.x * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * nt;
    v[j] = 0.f;
    if (i < D) {
      float a = to_f32(x[base + i]);
      if (y != nullptr) {
        const T r = from_f32<T>(a + to_f32(y[base + i]));
        x_out[base + i] = r;
        a = to_f32(r);
      }
      v[j] = a;
      s = RMS ? __fadd_rn(s, __fmul_rn(a, a)) : s + a;
    }
  }
  const float inv_d = 1.f / (float)D;
  float mu = 0.f, r;
  if (RMS) {
    r = rsqrtf(block_sum(s, red) * inv_d + eps);
  } else {
    mu = block_sum(s, red) * inv_d;
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (tid + j * nt < D) {
        const float d = v[j] - mu;
        s2 = __fadd_rn(s2, __fmul_rn(d, d));
      }
    }
    r = rsqrtf(block_sum(s2, red) * inv_d + eps);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * nt;
    if (i < D) {
      float o = __fmul_rn(RMS ? v[j] : v[j] - mu, r);
      if (w != nullptr) o = __fmul_rn(o, to_f32(w[i]));
      h[base + i] = from_f32<T>(o);
    }
  }
}

template <typename T, bool RMS>
cudaError_t launch_add_norm(const void* x, const void* y, const void* w,
                            void* x_out, void* h, int rows, int D, int threads,
                            float eps, cudaStream_t stream) {
  const int per = (D + threads - 1) / threads;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  T* xo = static_cast<T*>(x_out);
  T* hp = static_cast<T*>(h);
  if (per <= 4)
    add_norm_kernel<T, RMS, 4><<<rows, threads, 0, stream>>>(xp, yp, wp, xo,
                                                             hp, D, eps);
  else if (per <= 8)
    add_norm_kernel<T, RMS, 8><<<rows, threads, 0, stream>>>(xp, yp, wp, xo,
                                                             hp, D, eps);
  else if (per <= 16)
    add_norm_kernel<T, RMS, 16><<<rows, threads, 0, stream>>>(xp, yp, wp, xo,
                                                              hp, D, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// One thread per (row b, head hh of the nh + 2 nkv heads of q, k and v,
// pair i < dh / 2).  Heads below nh are q's, then k's, then v's.
template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_qk_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ freqs,
                     const int* __restrict__ pos_ptr, int pos_scalar,
                     T* __restrict__ q_out, T* __restrict__ kc,
                     T* __restrict__ vc, const int* __restrict__ table,
                     int B, int nh, int nkv, int dh, int rope, int W, int n_b,
                     int bt, long long ps, long long ss, long long hs) {
  const int half = dh >> 1, heads = nh + 2 * nkv;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * heads * half) return;
  const int i = (int)(idx % half);
  const long long t = idx / half;
  const int hh = (int)(t % heads), b = (int)(t / heads);
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_scalar;
  const T* src;
  T* dst;
  if (hh < nh) {
    src = q + ((long long)b * nh + hh) * dh;
    dst = q_out + ((long long)b * nh + hh) * dh;
  } else {
    const bool is_k = hh < nh + nkv;
    const int h = hh - nh - (is_k ? 0 : nkv);
    src = (is_k ? k : v) + ((long long)b * nkv + h) * dh;
    long long off;
    if (table != nullptr) {
      const int blk = pos / bt;
      if (blk >= n_b) return;          // past the row's table: no slot
      off = (long long)table[(long long)b * n_b + blk] * ps
          + (long long)(pos % bt) * ss + (long long)h * hs;
    } else {
      off = (((long long)b * W + pos % W) * nkv + h) * dh;
    }
    dst = (is_k ? kc : vc) + off;
    if (!is_k) {                      // v: copied as it is
      dst[i] = src[i];
      dst[i + half] = src[i + half];
      return;
    }
  }
  if (!rope) {
    dst[i] = src[i];
    dst[i + half] = src[i + half];
    return;
  }
  const float ang = __fmul_rn((float)pos, freqs[i]);
  const float c = cosf(ang), s = sinf(ang);
  const float x1 = to_f32(src[i]), x2 = to_f32(src[i + half]);
  dst[i] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  dst[i + half] = from_f32<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

template <typename T>
cudaError_t launch_rope(const void* q, const void* k, const void* v,
                        const void* freqs, const void* pos, int pos_scalar,
                        void* q_out, void* kc, void* vc, const void* table,
                        int B, int nh, int nkv, int dh, int rope, int W,
                        int n_b, int bt, long long ps, long long ss,
                        long long hs, cudaStream_t stream) {
  const long long n = (long long)B * (nh + 2 * nkv) * (dh / 2);
  const int blocks = (int)((n + ROPE_THREADS - 1) / ROPE_THREADS);
  rope_qk_write_kernel<T><<<blocks, ROPE_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(freqs),
      static_cast<const int*>(pos), pos_scalar, static_cast<T*>(q_out),
      static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const int*>(table), B, nh, nkv, dh, rope, W, n_b, bt, ps,
      ss, hs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, x_out, h (rows, D); w (D): float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous.  y and w may be null (no add; no weight); x_out
// is written only with y.  rms: 1 for rmsnorm, 0 for layernorm.  threads:
// a multiple of 32 up to 1024 with D <= 16 * threads.
int add_norm(const void* x, const void* y, const void* w, void* x_out,
             void* h, int rows, int D, int threads, int rms, float eps,
             int bf16, void* stream) {
  if (threads % 32 || threads > MAX_THREADS || threads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)(rms ? launch_add_norm<__nv_bfloat16, true>(
                           x, y, w, x_out, h, rows, D, threads, eps, s)
                     : launch_add_norm<__nv_bfloat16, false>(
                           x, y, w, x_out, h, rows, D, threads, eps, s));
  return (int)(rms ? launch_add_norm<float, true>(x, y, w, x_out, h, rows, D,
                                                  threads, eps, s)
                   : launch_add_norm<float, false>(x, y, w, x_out, h, rows,
                                                   D, threads, eps, s));
}

// q, q_out (B, nh, dh), k, v (B, nkv, dh) contiguous, float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), dh even; freqs (dh / 2) float32; pos: an int32
// device scalar, or null to use pos_scalar.  rope = 0 copies q and k
// unrotated.  Slab (table null): kc, vc (B, W, nkv, dh) contiguous, the
// token at slot pos % W.  Paged: kc, vc arena views with element strides
// ps, ss, hs (k and v alike) and a contiguous d_head axis, table (B, n_b)
// int32, the token at page table[b, pos / bt], offset pos % bt.
int rope_qk_write(const void* q, const void* k, const void* v,
                  const void* freqs, const void* pos, int pos_scalar,
                  void* q_out, void* kc, void* vc, const void* table, int B,
                  int nh, int nkv, int dh, int rope, int W, int n_b, int bt,
                  long long ps, long long ss, long long hs, int bf16,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_rope<__nv_bfloat16>(q, k, v, freqs, pos, pos_scalar,
                                           q_out, kc, vc, table, B, nh, nkv,
                                           dh, rope, W, n_b, bt, ps, ss, hs,
                                           s);
  return (int)launch_rope<float>(q, k, v, freqs, pos, pos_scalar, q_out, kc,
                                 vc, table, B, nh, nkv, dh, rope, W, n_b, bt,
                                 ps, ss, hs, s);
}

}  // extern "C"

// One-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _decode_kernel of
// src/repro/kernels/flash_decode.py (wrapper repro/kernels/ops.py
// flash_decode).  q (B, nh, dh) attends over the slot cache k/v
// (B, W, nkv, dh); slots >= n_valid[b] are masked; the G = nh / nkv query
// heads of one kv head share its tiles.  Online softmax in float32 (running
// max, denominator, weighted sum), output divided by max(l, 1e-30), in
// q's type.
//
// What bounds it on an H100: the bytes of the valid cache slots,
// 2 * B * n_valid * nkv * dh * sizeof(T), against 3.35 TB/s; the arithmetic
// is about one multiply-add per byte.
//
// Design: one block per (b, kv head) walks the sequence in tiles of BS
// slots inside the block (Hopper has no sequential grid axis, and nothing
// is carried between blocks), so each cache byte is read once.  Tiles past
// n_valid are not read at all.  The K and V tiles go to shared memory
// converted to float32, with an odd row stride so that the per-slot dot
// products hit distinct banks; dh need not be a power of two (BLOOM's 80 is
// handled by bounds, not by padding).  Every sum is taken in a fixed order
// (no atomics), so the result is deterministic.  The tiles are not double
// buffered yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BS = 64;          // slots per tile
constexpr int THREADS = 128;
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

__host__ __device__ inline size_t smem_floats(int G, int dh) {
  const int ds = row_stride(dh);
  // q, acc: G*dh each; k, v tiles: BS*ds each; scores G*BS; m, l, alpha: G
  return (size_t)2 * G * dh + (size_t)2 * BS * ds + (size_t)G * BS + 3 * G;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ n_valid,
                    int nv_scalar, T* __restrict__ out, int nh, int nkv,
                    int W, int dh, float scale) {
  extern __shared__ float smem[];
  const int G = nh / nkv, ds = row_stride(dh);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = smem;                 // (G, dh), pre-scaled
  float* acc = qs + G * dh;         // (G, dh)
  float* ks = acc + G * dh;         // (BS, ds)
  float* vs = ks + BS * ds;         // (BS, ds)
  float* sc = vs + BS * ds;         // (G, BS) scores, then probabilities
  float* m = sc + G * BS;           // (G,)
  float* l = m + G;                 // (G,)
  float* alpha = l + G;             // (G,)

  int nv = n_valid ? n_valid[b] : nv_scalar;
  nv = min(nv, W);

  for (int i = tid; i < G * dh; i += THREADS) {
    qs[i] = to_f32(q[((size_t)b * nh + (size_t)h * G) * dh + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) { m[g] = NEG; l[g] = 0.f; }
  __syncthreads();

  for (int s0 = 0; s0 < nv; s0 += BS) {
    const int bs = min(BS, nv - s0);
    for (int i = tid; i < bs * dh; i += THREADS) {
      const int j = i / dh, d = i % dh;
      const size_t src = (((size_t)b * W + s0 + j) * nkv + h) * dh + d;
      ks[j * ds + d] = to_f32(k[src]);
      vs[j * ds + d] = to_f32(v[src]);
    }
    __syncthreads();
    for (int i = tid; i < G * BS; i += THREADS) {
      const int g = i / BS, j = i % BS;
      float s = NEG;
      if (j < bs) {
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
        const float p = expf(sc[g * BS + j] - m_new);
        sc[g * BS + j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);
        alpha[g] = a;
        l[g] = a * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * dh; i += THREADS) {
      const int g = i / dh, d = i % dh;
      float o = acc[i] * alpha[g];
      for (int j = 0; j < bs; ++j) o = fmaf(sc[g * BS + j], vs[j * ds + d], o);
      acc[i] = o;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh;
    out[((size_t)b * nh + (size_t)h * G) * dh + i] = from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* n_valid,
           int nv_scalar, void* out, int B, int nh, int nkv, int W, int dh,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(nh / nkv, dh) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nkv, B);
  flash_decode_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      n_valid, nv_scalar, static_cast<T*>(out), nh, nkv, W, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, nh, dh), k/v (B, W, nkv, dh), out (B, nh, dh): float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), contiguous.  n_valid: (B,) int32 device pointer,
// or null to use nv_scalar for every row.  scale = 1/sqrt(dh), applied to q.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* n_valid, int nv_scalar, void* out, int B, int nh,
                 int nkv, int W, int dh, float scale, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto nvp = static_cast<const int*>(n_valid);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, nvp, nv_scalar, out, B, nh, nkv, W, dh, scale, st)
              : launch<float>(q, k, v, nvp, nv_scalar, out, B, nh, nkv, W, dh, scale, st);
}

}  // extern "C"

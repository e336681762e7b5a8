// Quantized matmul tiers for Hopper (sm_90a): W8A16, W4A16 and W8A8.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quant_matmul.py:
//   _mm_kernel_int8  (W8A16)  -> mode MODE_W8
//   _mm_kernel_int4  (W4A16, with _unpack_int4_tile) -> mode MODE_W4
//   _mm_kernel_w8a8  (W8A8, int32 accumulation)      -> mode MODE_A8
// out (M, N) = x (M, K) @ (q (K, N) * scale (N,))  [A16 tiers, f32 sums]
// out (M, N) = float(xq (M, K) @ q (K, N)) * sx (M,) * sw (N,)  [W8A8]
// q is int8 (K, N) row-major, or for W4 packed (ceil(K/2), N): packed row
// p holds row 2p in its low nibble and row 2p+1 in its high nibble.
//
// What bounds it on an H100: at decode (M = batch <= 8) the weight stream,
// K*N bytes (K*N/2 for W4) against 3.35 TB/s; the arithmetic is tiny.  At
// prefill (M = batch * prompt length) the operations, 2*M*N*K.
//
// Design for the weight stream (skinny kernel, M <= 8): the weights go from
// device memory straight to registers, each warp reading whole 32-byte
// sectors of a weight row for four column groups at once, and are
// dequantized in registers; x sits in shared memory and is broadcast.  To
// fill all SMs at small N the K axis is split across blocks (split-K); the
// partial sums go to a scratch buffer and a second kernel adds them in a
// fixed order, so the result does not depend on scheduling.  For prefill a
// tiled kernel keeps 64x64 output tiles in registers (4x4 per thread) over
// shared-memory tiles of x and the dequantized weights; W8A8 packs four k
// values per 32-bit word and accumulates with __dp4a in int32.  Neither
// uses tensor cores yet (wgmma and TMA are later work), so prefill runs at
// CUDA-core rate.  Integer sums are exact, so W8A8 is bitwise equal to its
// plain PyTorch version, including the writeout float(acc) * sx * sw.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MODE_W8 = 0;
constexpr int MODE_W4 = 1;
constexpr int MODE_A8 = 2;

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

// int4 nibbles of a packed byte (sign-extended int8 value in an int)
__device__ __forceinline__ int lo_nibble(int b) { return ((b & 0x0F) ^ 0x08) - 0x08; }
__device__ __forceinline__ int hi_nibble(int b) { return b >> 4; }

// weight value q[k, n] as an integer
template <int MODE>
__device__ __forceinline__ int load_q(const int8_t* __restrict__ q, int k, int n, int N) {
  if (MODE == MODE_W4) {
    int b = q[(size_t)(k >> 1) * N + n];
    return (k & 1) ? hi_nibble(b) : lo_nibble(b);
  }
  return q[(size_t)k * N + n];
}

// the W8A8 writeout, in the plain version's order: float(acc) * sx * sw
template <typename TO>
__device__ __forceinline__ TO a8_out(int acc, float sx, float sw) {
  return from_f32<TO>(__fmul_rn(__fmul_rn((float)acc, sx), sw));
}

// ---------------------------------------------------------------------------
// Skinny kernel (M <= 8 rows per blockIdx.z): weight stream in registers
// ---------------------------------------------------------------------------

constexpr int SK_WARPS = 8;
constexpr int SK_ROWS = 8;     // rows of x per block
constexpr int SK_COLS = 4;     // column groups of 32 per lane
constexpr int SK_BN = 32 * SK_COLS;
constexpr int SK_KC = 256;     // k values of x staged per pass (even)

// XT: element type of x (float / bf16 for A16, int8 for A8); TO: output.
template <int MODE, typename XT, typename TO>
__global__ void __launch_bounds__(SK_WARPS * 32)
qmm_skinny(const XT* __restrict__ x, const float* __restrict__ sx,
           const int8_t* __restrict__ q, const float* __restrict__ sw,
           TO* __restrict__ out, void* __restrict__ partial,
           int M, int N, int K, int k_per_split) {
  using Acc = typename std::conditional<MODE == MODE_A8, int, float>::type;
  __shared__ Acc xs[SK_ROWS][SK_KC + 1];
  __shared__ Acc red[SK_WARPS][SK_ROWS][SK_BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * SK_BN;
  const int m0 = blockIdx.z * SK_ROWS;
  const int kb = blockIdx.y * k_per_split;
  const int ke = min(K, kb + k_per_split);

  Acc acc[SK_ROWS][SK_COLS];
  float s[SK_COLS];
#pragma unroll
  for (int j = 0; j < SK_COLS; ++j) {
    const int n = n0 + j * 32 + lane;
    s[j] = (MODE != MODE_A8 && n < N) ? sw[n] : 0.f;
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) acc[r][j] = 0;
  }

  for (int k0 = kb; k0 < ke; k0 += SK_KC) {
    const int kc = min(SK_KC, ke - k0);
    for (int i = tid; i < SK_ROWS * SK_KC; i += SK_WARPS * 32) {
      const int r = i / SK_KC, c = i % SK_KC, gm = m0 + r;
      Acc v = 0;
      if (gm < M && c < kc) {
        if constexpr (MODE == MODE_A8) v = (Acc)x[(size_t)gm * K + k0 + c];
        else v = (Acc)to_f32(x[(size_t)gm * K + k0 + c]);
      }
      xs[r][c] = v;
    }
    if (tid < SK_ROWS) xs[tid][SK_KC] = 0;
    __syncthreads();
    if (MODE == MODE_W4) {
      // one packed row = two k values; k0 is even (k_per_split and SK_KC are)
#pragma unroll 2
      for (int u = warp; 2 * u < kc; u += SK_WARPS) {
        const size_t prow = (size_t)((k0 >> 1) + u) * N;
        int b[SK_COLS];
#pragma unroll
        for (int j = 0; j < SK_COLS; ++j) {
          const int n = n0 + j * 32 + lane;
          b[j] = n < N ? q[prow + n] : 0;
        }
#pragma unroll
        for (int j = 0; j < SK_COLS; ++j) {
          const float w0 = (float)lo_nibble(b[j]) * s[j];
          const float w1 = (float)hi_nibble(b[j]) * s[j];
#pragma unroll
          for (int r = 0; r < SK_ROWS; ++r) {
            acc[r][j] = fmaf(xs[r][2 * u], w0, acc[r][j]);
            acc[r][j] = fmaf(xs[r][2 * u + 1], w1, acc[r][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int c = warp; c < kc; c += SK_WARPS) {
        const size_t row = (size_t)(k0 + c) * N;
        int b[SK_COLS];
#pragma unroll
        for (int j = 0; j < SK_COLS; ++j) {
          const int n = n0 + j * 32 + lane;
          b[j] = n < N ? q[row + n] : 0;
        }
#pragma unroll
        for (int j = 0; j < SK_COLS; ++j) {
          if (MODE == MODE_A8) {
#pragma unroll
            for (int r = 0; r < SK_ROWS; ++r) acc[r][j] += xs[r][c] * (Acc)b[j];
          } else {
            const float w = (float)b[j] * s[j];
#pragma unroll
            for (int r = 0; r < SK_ROWS; ++r) acc[r][j] = fmaf(xs[r][c], w, acc[r][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < SK_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < SK_COLS; ++j) red[warp][r][j * 32 + lane] = acc[r][j];
  __syncthreads();
  for (int i = tid; i < SK_ROWS * SK_BN; i += SK_WARPS * 32) {
    const int r = i / SK_BN, c = i % SK_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    Acc sum = 0;
    for (int w = 0; w < SK_WARPS; ++w) sum += red[w][r][c];   // fixed order
    if (gridDim.y > 1) {
      static_cast<Acc*>(partial)[((size_t)blockIdx.y * M + gm) * N + gn] = sum;
    } else if (MODE == MODE_A8) {
      out[(size_t)gm * N + gn] = a8_out<TO>((int)sum, sx[gm], sw[gn]);
    } else {
      out[(size_t)gm * N + gn] = from_f32<TO>((float)sum);
    }
  }
}

// second pass of split-K: add the splits in order, then write out
template <int MODE, typename TO>
__global__ void qmm_reduce_splits(const void* __restrict__ partial,
                                  const float* __restrict__ sx,
                                  const float* __restrict__ sw,
                                  TO* __restrict__ out, int M, int N, int splits) {
  using Acc = typename std::conditional<MODE == MODE_A8, int, float>::type;
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    const Acc* p = static_cast<const Acc*>(partial);
    Acc sum = 0;
    for (int s = 0; s < splits; ++s) sum += p[s * MN + i];
    if (MODE == MODE_A8) out[i] = a8_out<TO>((int)sum, sx[i / N], sw[i % N]);
    else out[i] = from_f32<TO>((float)sum);
  }
}

// ---------------------------------------------------------------------------
// Tiled kernel (prefill): 64x64 output tile per block, 4x4 per thread
// ---------------------------------------------------------------------------

constexpr int TL_BM = 64, TL_BN = 64, TL_TM = 4, TL_TN = 4;
constexpr int TL_THREADS = (TL_BM / TL_TM) * (TL_BN / TL_TN);   // 256
constexpr int TL_BK = 16;        // A16: k per tile
constexpr int TL_BK4 = 16;       // A8: packed 4-k words per tile (64 k)

template <int MODE, typename XT, typename TO>
__global__ void __launch_bounds__(TL_THREADS)
qmm_tiled(const XT* __restrict__ x, const float* __restrict__ sx,
          const int8_t* __restrict__ q, const float* __restrict__ sw,
          TO* __restrict__ out, int M, int N, int K) {
  const int tid = threadIdx.x;
  const int tx = tid % (TL_BN / TL_TN), ty = tid / (TL_BN / TL_TN);
  const int m0 = blockIdx.y * TL_BM, n0 = blockIdx.x * TL_BN;

  if constexpr (MODE == MODE_A8) {
    __shared__ int xs[TL_BK4][TL_BM + 4];   // 4 consecutive k of a row
    __shared__ int ws[TL_BK4][TL_BN];       // 4 consecutive k of a column
    int acc[TL_TM][TL_TN] = {};
    for (int k0 = 0; k0 < K; k0 += 4 * TL_BK4) {
      for (int i = tid; i < TL_BM * TL_BK4; i += TL_THREADS) {
        const int r = i / TL_BK4, c = i % TL_BK4, gm = m0 + r;
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + 4 * c + e;
          const int v = (gm < M && gk < K) ? (int)x[(size_t)gm * K + gk] : 0;
          word |= (uint32_t)(v & 0xFF) << (8 * e);
        }
        xs[c][r] = (int)word;
      }
      for (int i = tid; i < TL_BK4 * TL_BN; i += TL_THREADS) {
        const int c = i / TL_BN, nn = i % TL_BN, gn = n0 + nn;
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + 4 * c + e;
          const int v = (gn < N && gk < K) ? (int)q[(size_t)gk * N + gn] : 0;
          word |= (uint32_t)(v & 0xFF) << (8 * e);
        }
        ws[c][nn] = (int)word;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < TL_BK4; ++c) {
        int a[TL_TM], b[TL_TN];
#pragma unroll
        for (int i = 0; i < TL_TM; ++i) a[i] = xs[c][ty * TL_TM + i];
#pragma unroll
        for (int j = 0; j < TL_TN; ++j) b[j] = ws[c][tx * TL_TN + j];
#pragma unroll
        for (int i = 0; i < TL_TM; ++i)
#pragma unroll
          for (int j = 0; j < TL_TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TL_TM; ++i)
#pragma unroll
      for (int j = 0; j < TL_TN; ++j) {
        const int gm = m0 + ty * TL_TM + i, gn = n0 + tx * TL_TN + j;
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = a8_out<TO>(acc[i][j], sx[gm], sw[gn]);
      }
  } else {
    __shared__ __align__(16) float xs[TL_BK][TL_BM + 4];   // x tile, k-major
    __shared__ __align__(16) float ws[TL_BK][TL_BN];       // dequantized weights
    float acc[TL_TM][TL_TN] = {};
    for (int k0 = 0; k0 < K; k0 += TL_BK) {
      for (int i = tid; i < TL_BM * TL_BK; i += TL_THREADS) {
        const int r = i / TL_BK, c = i % TL_BK, gm = m0 + r, gk = k0 + c;
        xs[c][r] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
      }
      for (int i = tid; i < TL_BK * TL_BN; i += TL_THREADS) {
        const int c = i / TL_BN, nn = i % TL_BN, gk = k0 + c, gn = n0 + nn;
        ws[c][nn] = (gk < K && gn < N) ? (float)load_q<MODE>(q, gk, gn, N) * sw[gn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < TL_BK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[c][ty * TL_TM]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[c][tx * TL_TN]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TL_TM; ++i)
#pragma unroll
          for (int j = 0; j < TL_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TL_TM; ++i)
#pragma unroll
      for (int j = 0; j < TL_TN; ++j) {
        const int gm = m0 + ty * TL_TM + i, gn = n0 + tx * TL_TN + j;
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = from_f32<TO>(acc[i][j]);
      }
  }
}

template <int MODE, typename XT, typename TO>
int launch(const void* x, const float* sx, const int8_t* q, const float* sw,
           void* out, void* partial, int M, int N, int K, int splits,
           int k_per_split, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  TO* op = static_cast<TO*>(out);
  if (M <= SK_ROWS) {
    dim3 grid((N + SK_BN - 1) / SK_BN, splits, (M + SK_ROWS - 1) / SK_ROWS);
    qmm_skinny<MODE, XT, TO><<<grid, SK_WARPS * 32, 0, stream>>>(
        xp, sx, q, sw, op, partial, M, N, K, k_per_split);
    if (splits > 1) {
      const int blocks = (int)(((size_t)M * N + 255) / 256);
      qmm_reduce_splits<MODE, TO><<<blocks, 256, 0, stream>>>(
          partial, sx, sw, op, M, N, splits);
    }
  } else {
    dim3 grid((N + TL_BN - 1) / TL_BN, (M + TL_BM - 1) / TL_BM);
    qmm_tiled<MODE, XT, TO><<<grid, TL_THREADS, 0, stream>>>(xp, sx, q, sw, op, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// W8A16 (bits 8) / W4A16 (bits 4): x and out are float32 (bf16 = 0) or
// bfloat16 (bf16 = 1).  ``partial`` is (splits, M, N) float32 scratch when
// splits > 1 (only for M <= 8); k_per_split is a multiple of 256.
int qmm_a16(const void* x, const void* q, const void* scale, void* out,
            void* partial, int M, int N, int K, int bits, int bf16,
            int splits, int k_per_split, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  if (bits == 4) {
    return bf16 ? launch<MODE_W4, __nv_bfloat16, __nv_bfloat16>(x, nullptr, qp, sp, out, partial, M, N, K, splits, k_per_split, st)
                : launch<MODE_W4, float, float>(x, nullptr, qp, sp, out, partial, M, N, K, splits, k_per_split, st);
  }
  return bf16 ? launch<MODE_W8, __nv_bfloat16, __nv_bfloat16>(x, nullptr, qp, sp, out, partial, M, N, K, splits, k_per_split, st)
              : launch<MODE_W8, float, float>(x, nullptr, qp, sp, out, partial, M, N, K, splits, k_per_split, st);
}

// W8A8: xq int8 (M, K) with row scales sx (M,) float32; out float32
// (out_bf16 = 0) or bfloat16 (1).  ``partial`` is (splits, M, N) int32.
int qmm_a8(const void* xq, const void* sx, const void* q, const void* sw,
           void* out, void* partial, int M, int N, int K, int out_bf16,
           int splits, int k_per_split, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  return out_bf16
      ? launch<MODE_A8, int8_t, __nv_bfloat16>(xq, sxp, qp, swp, out, partial, M, N, K, splits, k_per_split, st)
      : launch<MODE_A8, int8_t, float>(xq, sxp, qp, swp, out, partial, M, N, K, splits, k_per_split, st);
}

}  // extern "C"

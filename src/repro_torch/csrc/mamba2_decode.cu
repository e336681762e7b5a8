// One Mamba2 layer's decode step after its input projection, for Hopper
// (sm_90a): the causal conv's update, the selective state's update and
// read, the D skip, the gate and the grouped RMSNorm, in two kernels.
//
// No Pallas kernel is replaced: the JAX package's Mamba2 decode step is
// XLA ops (src/repro/models/mamba2.py: block_decode), and so is the
// port's op chain (src/repro_torch/models/mamba2.py: block_decode with
// use_kernel off), which ran about 60 kernels a layer; at Zamba2-7B-
// Instruct's 81 layers a decode step held 5,989 kernel nodes.
//
// proj (B, d_proj) is the layer's input projection of one token a row,
// [z (d_inner) | xBC (C) | dt (H)], C = d_inner + 2 G N, d_inner = H P;
// B and C come in G groups of N, heads [g H/G, (g+1) H/G) reading group g.
//
// mamba2_scan_step: one block per (row b, head h).  The head's P x
// channels and its group's N B and N C channels go through the causal
// conv of width K (taps conv_w (K, C), optional bias), from the conv
// state (B, K-1, C) (the last K-1 inputs, read only here) and the new
// input, then SiLU.  The chain's roundings are kept: each tap's product
// and each running sum rounded to the model type T, the bias add and the
// SiLU too.  Then, in float32 with the chain's operations in its order,
// none contracted to an fma:
//   dt    = softplus(dt_raw + dt_bias)   (x if x > 20, else log1p(exp x))
//   decay = exp(dt * -exp(A_log))
//   S     = S * decay + (x * dt) * B      (S (P, N), in place)
//   y     = T(S C + x * D)               (S C: a fixed-order warp sum)
// Warp w takes rows p = w, w + 8, ...; lane l the state columns n = l,
// l + 32, ...: a row of S is read and written once, coalesced.
//
// mamba2_gate_norm: one block per (row b, group g) over the group's
// d_inner / G channels: v = T(y * T(silu(z))), then
// out = T(v * rsqrt(mean(v^2) + eps) * w), the mean a fixed-order block
// sum; and the conv state's shift for the group's C / G channels (state
// row k <- row k + 1, the last row <- the new input), which the scan of
// the same step has read before (stream order).
//
// What bounds them: bytes.  At Zamba2-7B-Instruct's B = 8, H = 112,
// P = N = 64 the scan reads and writes 14.7 MB of float32 state a layer
// (8.8 us at 3.35 TB/s); the gate and norm move about 0.3 MB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;
constexpr int NORM_THREADS = 512;

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
// v rounded to T, as a float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// The block's sum of one value per thread in a fixed order (as
// decode_glue.cu's block_sum); red: 33 floats of shared memory.
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
  __syncthreads();
  return total;
}

// SiLU of the causal conv of channel ch of one row: the K - 1 inputs of
// the state (rows of C), then the new input x_new[ch].
template <typename T>
__device__ float conv_silu(const T* state, const T* x_new, const T* w,
                           const T* bias, int ch, int C, int K) {
  float acc = 0.f;
  for (int i = 0; i < K; ++i) {
    const float xv = to_f32(i < K - 1 ? state[(long long)i * C + ch]
                                      : x_new[ch]);
    const float p = rnd<T>(__fmul_rn(xv, to_f32(w[(long long)i * C + ch])));
    acc = i == 0 ? p : rnd<T>(__fadd_rn(acc, p));
  }
  if (bias != nullptr) acc = rnd<T>(__fadd_rn(acc, to_f32(bias[ch])));
  return rnd<T>(silu(acc));
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
mamba2_scan_step_kernel(const T* __restrict__ proj,
                        const T* __restrict__ conv_state,
                        const T* __restrict__ conv_w,
                        const T* __restrict__ conv_b,
                        const float* __restrict__ dt_bias,
                        const float* __restrict__ A_log,
                        const float* __restrict__ Dskip,
                        float* __restrict__ ssm, T* __restrict__ y,
                        int H, int P, int N, int G, int K) {
  extern __shared__ float sh[];            // x (P), B (N), C (N), dt, decay
  float* xs = sh;
  float* bs = xs + P;
  float* cs = bs + N;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int d_inner = H * P, C = d_inner + 2 * G * N;
  const long long d_proj = (long long)d_inner + C + H;
  const T* row = proj + (long long)b * d_proj;
  const T* x_new = row + d_inner;
  const T* st = conv_state + (long long)b * (K - 1) * C;
  for (int i = threadIdx.x; i < P + 2 * N; i += blockDim.x) {
    const int ch = i < P ? h * P + i
                         : i < P + N ? d_inner + g * N + (i - P)
                                     : d_inner + G * N + g * N + (i - P - N);
    xs[i] = conv_silu<T>(st, x_new, conv_w, conv_b, ch, C, K);
  }
  if (threadIdx.x == 0) {
    const float v = __fadd_rn(to_f32(row[d_inner + C + h]), dt_bias[h]);
    const float dt = v > 20.f ? v : log1pf(expf(v));
    sh[P + 2 * N] = dt;
    sh[P + 2 * N + 1] = expf(__fmul_rn(dt, -expf(A_log[h])));
  }
  __syncthreads();
  const float dt = sh[P + 2 * N], decay = sh[P + 2 * N + 1];
  const float dskip = Dskip[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* S = ssm + ((long long)b * H + h) * P * N;
  for (int p = warp; p < P; p += nwarps) {
    const float xdt = __fmul_rn(xs[p], dt);
    float part = 0.f;
    for (int n = lane; n < N; n += 32) {
      const long long idx = (long long)p * N + n;
      const float s = __fadd_rn(__fmul_rn(S[idx], decay),
                                __fmul_rn(xdt, bs[n]));
      S[idx] = s;
      part = __fadd_rn(part, __fmul_rn(s, cs[n]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    if (lane == 0)
      y[(long long)b * d_inner + h * P + p] =
          from_f32<T>(__fadd_rn(part, __fmul_rn(xs[p], dskip)));
  }
}

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
mamba2_gate_norm_kernel(const T* __restrict__ proj, const T* __restrict__ y,
                        const T* __restrict__ w, T* __restrict__ conv_state,
                        T* __restrict__ out, int H, int P, int N, int G,
                        int K, float eps) {
  __shared__ float red[33];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int d_inner = H * P, C = d_inner + 2 * G * N, gs = d_inner / G;
  const long long d_proj = (long long)d_inner + C + H;
  const T* row = proj + (long long)b * d_proj;
  const long long base = (long long)b * d_inner + (long long)g * gs;
  float s = 0.f;
  for (int i = threadIdx.x; i < gs; i += blockDim.x) {
    const float v = rnd<T>(__fmul_rn(to_f32(y[base + i]),
                                     rnd<T>(silu(to_f32(row[g * gs + i])))));
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  const float r = rsqrtf(__fadd_rn(block_sum(s, red) / (float)gs, eps));
  for (int i = threadIdx.x; i < gs; i += blockDim.x) {
    const float v = rnd<T>(__fmul_rn(to_f32(y[base + i]),
                                     rnd<T>(silu(to_f32(row[g * gs + i])))));
    out[base + i] = from_f32<T>(__fmul_rn(__fmul_rn(v, r),
                                          to_f32(w[g * gs + i])));
  }
  // the conv state's shift, this group's share of the row's channels
  T* st = conv_state + (long long)b * (K - 1) * C;
  const int cg = C / G;
  for (int c = g * cg + threadIdx.x; c < (g + 1) * cg; c += blockDim.x) {
    for (int k = 0; k + 1 < K - 1; ++k)
      st[(long long)k * C + c] = st[(long long)(k + 1) * C + c];
    st[(long long)(K - 2) * C + c] = row[d_inner + c];
  }
}

template <typename T>
cudaError_t launch(const void* proj, void* conv_state, const void* conv_w,
                   const void* conv_b, const void* dt_bias, const void* A_log,
                   const void* Dskip, void* ssm, void* y, const void* w,
                   void* out, int B, int H, int P, int N, int G, int K,
                   float eps, cudaStream_t stream) {
  const size_t shm = (size_t)(P + 2 * N + 2) * sizeof(float);
  mamba2_scan_step_kernel<T><<<B * H, SCAN_THREADS, shm, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(conv_state),
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),
      static_cast<const float*>(Dskip), static_cast<float*>(ssm),
      static_cast<T*>(y), H, P, N, G, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mamba2_gate_norm_kernel<T><<<B * G, NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<T*>(conv_state),
      static_cast<T*>(out), H, P, N, G, K, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// proj (B, d_inner + C + H), conv_state (B, K-1, C), conv_w (K, C),
// conv_b (C) or null, y and out (B, d_inner), w (d_inner): float32
// (bf16 = 0) or bfloat16 (bf16 = 1); dt_bias, A_log, Dskip (H) and ssm
// (B, H, P, N) float32; all contiguous.  H % G == 0, d_inner % G == 0,
// 2 <= K.  Updates ssm and conv_state in place; y is scratch; out gets
// the gated, normalized y.  Two launches: mamba2_scan_step, then
// mamba2_gate_norm.
int mamba2_decode(const void* proj, void* conv_state, const void* conv_w,
                  const void* conv_b, const void* dt_bias, const void* A_log,
                  const void* Dskip, void* ssm, void* y, const void* w,
                  void* out, int B, int H, int P, int N, int G, int K,
                  float eps, int bf16, void* stream) {
  if (G <= 0 || H % G || (H * P) % G || K < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(proj, conv_state, conv_w, conv_b,
                                      dt_bias, A_log, Dskip, ssm, y, w, out,
                                      B, H, P, N, G, K, eps, s);
  return (int)launch<float>(proj, conv_state, conv_w, conv_b, dt_bias, A_log,
                            Dskip, ssm, y, w, out, B, H, P, N, G, K, eps, s);
}

}  // extern "C"

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
// Six kernels; the wrapper (kernels/quant_matmul.py, route) picks one from
// the shapes and types before the launch:
//
// qmm_a16_gemv, W8A16 and W4A16 with bfloat16 x at M <= 8 (decode), where
//   16-byte loads read the operands (N % 16 == 0, for W4 an even K, q
//   16-byte and x 4-byte aligned); replaces _mm_kernel_int8 and
//   _mm_kernel_int4 (src/repro/kernels/quant_matmul.py:62, :79, with
//   _unpack_int4_tile :46; pallas_call :172) there.  Bound by the bytes,
//   K*N (K*N/2 for W4) + 2*M*K (x) + 4*N (scales) + 2*M*N (out) against
//   3.35 TB/s: the weights are nearly all of it.  The design is
//   qmm_a8_gemv's, so that the weight stream runs at the rate K2's does:
//   each lane reads the weights straight from device memory in 16-byte
//   pieces (16 columns of one k row, or of one packed row), 4 pieces a warp
//   step and GV_DEPTH steps in flight per warp, so a warp streams 2 KB a
//   step in full 128-byte lines; the arithmetic is bf16 mma.sync m16n8k16
//   with A = W^T (16 columns x 16 k) and B = x^T (16 k x the 8 rows of x,
//   zero for rows >= M), float32 sums.  Each int8 weight becomes an exact
//   bf16 in registers, bf16(128 + low 7 bits) - bf16(128 + 128 sign), and
//   each signed nibble n one, bf16(128 + (n ^ 8)) - bf16(136): a byte_perm,
//   one or two lop3 and a bf16x2 subtraction a pair of values, with no
//   shuffle, because a lane's k rows 4t .. 4t + 3 are the k slots 2t, 2t + 1, 2t + 8, 2t + 9 of
//   A and of B alike.  A W8 step is 16 k rows (lane t: rows 4t .. 4t + 3);
//   a W4 step is 32 k rows, 16 packed rows (lane t: packed rows 2t, 2t + 1,
//   2t + 8, 2t + 9, two mma k-chunks), so both keep 2 KB a warp in flight.
//   The products are exact in float32; the blocks split K (gemv_a16_plan,
//   from N, K and bits alone, never from M), the splits of a column tile
//   form one thread-block cluster and merge by qmm_a8_gemv's reduce-scatter
//   through distributed shared memory, each block adding its warps in warp
//   order and each owner the splits in rank order.  Then one
//   bf16(s[n] * sum) at writeout, as qmm_tc.  One launch, no workspace,
//   every element summed in one order whatever M is, so each row of an
//   M = 8 call is bitwise the same row computed alone.
//
// qmm_skinny (+ qmm_reduce_splits), W8A16 and W4A16 at M <= 8 where
//   qmm_a16_gemv does not go: float32 x (the reduced float32 models) and
//   operands 16-byte loads cannot read.  Bound by the weight stream as
//   above.  The weights go from device memory straight to registers, each
//   warp reading whole 32-byte sectors of a weight row for four column
//   groups at once, and are dequantized in registers; x sits in shared
//   memory and is broadcast.  To fill all SMs at small N the K axis is
//   split across blocks; a second kernel adds the partial sums in a fixed
//   order, so the result does not depend on scheduling.
//
// qmm_a8_gemv, W8A8 at M <= 8 (decode); replaces _mm_kernel_w8a8 there.
//   Bound by the bytes, K*N + M*K + 4*(M + N) + 2*M*N (bf16 out) against
//   3.35 TB/s: the int8 weights are nearly all of it.  Each lane reads the
//   weights straight from device memory in 16-byte pieces (16 columns of
//   one k row), 4 k rows a step, with GV_DEPTH steps in flight per warp, so
//   a warp streams 128 columns x 16 k rows a step in full 128-byte lines.
//   A 4x4 byte transpose in registers (__byte_perm) turns the 4 rows into
//   16 words of 4 k values of one column: the A operand of the int8
//   mma.sync m16n8k16 (W^T, 16 columns x 16 k), whose B operand is xq^T (16
//   k x the 8 rows of x, one 32-bit word of xq a lane; rows >= M are zero).
//   That is 8 mma a step where __dp4a would take 128, so the arithmetic
//   stays far below the byte bound.  Sums are exact int32, so K may be cut
//   anywhere: blocks split K (gemv_a8_plan, from the shapes alone), and the
//   splits of one column tile form one thread-block cluster.  Each block
//   sums its warps in shared memory, then the cluster reduce-scatters the
//   tile through distributed shared memory: each block receives every
//   split's sums for its share of the tile, behind one cluster barrier, and
//   writes float(acc) * sx[m] * sw[n] once.  One launch, no workspace, and
//   the result bitwise equal to the plain version (each row independent of
//   M) whatever the plan.  Shapes 16-byte loads cannot read (N % 16, K % 4,
//   unaligned bases) take the byte-load instantiation of the same kernel.
//   What bounds it at BLOOM's decode shapes: about 4 us of fixed cost a
//   call (launch, the first loads' latency, the merge) beside the stream.
//
// qmm_tc, W8A16 and W4A16 with bfloat16 x at M > 8 (prefill).  Bound by
//   the operations, 2*M*N*K against 989 TFLOP/s bf16, which only the tensor
//   cores reach.  The scale is per output column, so it leaves the sum:
//   out[m, n] = bf16(s[n] * sum_k x[m, k] * q[k, n]); int8 and int4 values
//   are exact in bf16 and their products exact in the float32 accumulator.
//   A 128x128 output tile per block walks K in stages of 64 over a ring of
//   QT_STAGES stages in shared memory.  One producer thread keeps TMA loads
//   of the x tile (128B-swizzled, the layout wgmma reads) and the raw int8
//   or packed int4 weight tile in flight, completing on a "full" mbarrier
//   per stage.  Two consumer warpgroups (64 output rows each) convert the
//   stage's weights to a bf16 tile in the 128B-swizzled N-major layout
//   (byte-permute into a float32 magic number, exact), fence the generic
//   stores to the async proxy, meet at a named barrier, and issue four
//   wgmma m64n128k16 with A = the x tile and B = the converted tile (its
//   descriptor's transpose bit names the N-major layout).  One wgmma group
//   stays in flight while the next stage converts; a stage goes back to the
//   producer through an "empty" mbarrier once its group has completed.  The
//   epilogue multiplies by s[n] and rounds to bf16.  Every output element
//   sums its k stages in one order whatever M is: no split-K.
//
// qmm_a8_wgmma, W8A8 at M > 8 (prefill) where the TMA takes the operands
//   (K % 16 == 0, N % 16 == 0, 16-byte aligned xq and q).  Bound by the
//   operations, 2*M*N*K against 1,979 TOPS int8, which only the int8
//   tensor cores reach (the CUDA-core qmm_tiled ran it at under 3 % of
//   that).  The sums must stay exact int32 (the kernel is held bitwise to
//   its plain version, and an FFN-down row of BLOOM-7B1 reaches 2.7e8, past
//   float32's exact 2^24), so it runs wgmma m64n128k32.s32.s8.s8.  The
//   integer wgmma has no transpose immediates: B must be K-major in shared
//   memory, and q is (K, N) with n contiguous.  So each stage's raw q tile
//   (128 k rows x 128 n bytes, loaded plain by the TMA) is transposed by the
//   consumers into a K-major tile (128 n rows x 128 k bytes, 128B-swizzled,
//   named like the xq tile): 4x4 byte blocks by __byte_perm, 16-byte
//   stores, no bank conflicts (a8_transpose).  No transposed copy of the
//   weights is kept in device memory.  A 256x128 output tile per block (two
//   warpgroups of 128 rows, two m64 accumulators of 64 int32 registers a
//   thread each) walks K in stages of 128 over a 3-stage ring of 64 KB; the
//   taller tile halves the weight bytes each output reads from L2, which
//   bounded the 128x128 version.  The ring, the producer thread, the
//   barriers and the fences are qmm_tc's.  The epilogue writes
//   float(acc) * sx[m] * s[n] (a8_out) once per output: no split-K, so the
//   result is bitwise equal to the plain version at every shape.
//
// qmm_tiled, the other M > 8 cases: float32 x (held to the CPU's tokens on
//   reduced float32 models) and shapes the TMA does not take (K % 8, or for
//   W8A8 K % 16, or N % 16 not 0, unaligned pointers).  64x64 output tiles
//   in registers (4x4 per thread) over shared-memory tiles of x and the
//   dequantized weights, on CUDA cores; W8A8 packs four k values per 32-bit
//   word and accumulates with __dp4a in int32.  Integer sums are exact, so
//   W8A8 is bitwise equal to its plain PyTorch version, including the
//   writeout float(acc) * sx * sw.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

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

// XT: element type of x (float / bf16); TO: output.
template <int MODE, typename XT, typename TO>
__global__ void __launch_bounds__(SK_WARPS * 32)
qmm_skinny(const XT* __restrict__ x, const float* __restrict__ sx,
           const int8_t* __restrict__ q, const float* __restrict__ sw,
           TO* __restrict__ out, void* __restrict__ partial,
           int M, int N, int K, int k_per_split) {
  using Acc = float;
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
    s[j] = n < N ? sw[n] : 0.f;
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) acc[r][j] = 0;
  }

  for (int k0 = kb; k0 < ke; k0 += SK_KC) {
    const int kc = min(SK_KC, ke - k0);
    for (int i = tid; i < SK_ROWS * SK_KC; i += SK_WARPS * 32) {
      const int r = i / SK_KC, c = i % SK_KC, gm = m0 + r;
      Acc v = 0;
      if (gm < M && c < kc) v = (Acc)to_f32(x[(size_t)gm * K + k0 + c]);
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
          const float w = (float)b[j] * s[j];
#pragma unroll
          for (int r = 0; r < SK_ROWS; ++r) acc[r][j] = fmaf(xs[r][c], w, acc[r][j]);
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
  using Acc = float;
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    const Acc* p = static_cast<const Acc*>(partial);
    Acc sum = 0;
    for (int s = 0; s < splits; ++s) sum += p[s * MN + i];
    out[i] = from_f32<TO>((float)sum);
  }
}

// ---------------------------------------------------------------------------
// W8A8 GEMV (M <= 8): 16-byte weight loads, 4x4 byte transposes, int8
// mma.sync; the K splits of a column tile merged inside a cluster
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int GV_ROWS = 8;         // rows of xq: the mma's n
constexpr int GV_WARPS = 4;        // warps of a block, all on one column tile
constexpr int GV_BN = 128;         // columns of a tile: 8 lane groups x 16
constexpr int GV_KSTEP = 16;       // k rows of a warp step: 4 lanes x 4 rows
constexpr int GV_DEPTH = 2;        // warp steps in flight per warp
constexpr int GV_MAX_SPLITS = 8;   // blocks of a cluster (the portable limit)

// a 16-byte piece of the weight stream, read once: not kept in L1
__device__ __forceinline__ uint4 ldg_stream(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows a, b, c, d (4 columns of k rows k .. k + 3) -> col[i]: the 4 k
// values of column i, row k in the low byte
__device__ __forceinline__ void gv_transpose(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                             uint32_t* col) {
  const uint32_t lo01 = __byte_perm(a, b, 0x5140);     // a0 b0 a1 b1
  const uint32_t hi01 = __byte_perm(a, b, 0x7362);     // a2 b2 a3 b3
  const uint32_t lo23 = __byte_perm(c, d, 0x5140);
  const uint32_t hi23 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);            // a0 b0 c0 d0
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// d (16x8 s32) += a (16x16 s8, row-major) x b (16x8 s8, column-major).
// Lane (g, t) = (lane / 4, lane % 4) holds a0 = A[g][4t ..], a1 = A[g + 8][4t ..],
// b = B[4t ..][g], d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}
__device__ __forceinline__ void mma_s8_16816(int* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]) : "r"(a0), "r"(a1), "r"(b));
}

// one lane's share of a warp step: q rows k0 .. k0 + 3 (k0 = 4 t past the
// step's first row) of columns n .. n + 15; rows at or past ke (the split's
// end) and columns past N read as zero
template <bool WIDE>
__device__ __forceinline__ void gv_load_q(const int8_t* __restrict__ q, int N, int ke, int k0,
                                          int n, uint4* w) {
  if (WIDE) {
    // N % 16 == 0, K % 4 == 0 and ke % 4 == 0: a piece is all in or all out
    const bool in = k0 < ke && n < N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = in ? ldg_stream(q + (size_t)(k0 + i) * N + n) : make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v[4] = {0, 0, 0, 0};
      if (k0 + i < ke) {
        const int8_t* row = q + (size_t)(k0 + i) * N;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (n + c < N) v[c >> 2] |= (uint32_t)(uint8_t)row[n + c] << (8 * (c & 3));
      }
      w[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// and its word of xq: xq[g][k0 .. k0 + 3], zero for rows g >= M
template <bool WIDE>
__device__ __forceinline__ uint32_t gv_load_x(const int8_t* __restrict__ xq, int M, int K, int ke,
                                              int k0, int g) {
  if (WIDE)
    return (g < M && k0 < ke) ? __ldg(reinterpret_cast<const unsigned*>(xq + (size_t)g * K + k0))
                              : 0u;
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (g < M && k0 + i < ke) x |= (uint32_t)(uint8_t)xq[(size_t)g * K + k0 + i] << (8 * i);
  return x;
}

// grid (column tiles, splits), cluster (1, splits): block (x, y) sums
// k in [y k_per_split, min(K, (y + 1) k_per_split)) for columns
// 128 x .. 128 x + 127, and the cluster's blocks write the tile out together
template <typename TO, bool WIDE>
__global__ void __launch_bounds__(GV_WARPS * 32)
qmm_a8_gemv(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ q, const float* __restrict__ sw, TO* __restrict__ out,
            int M, int N, int K, int k_per_split) {
  __shared__ int part[GV_WARPS][32 * 32];         // each warp's sums, [register][lane]
  __shared__ int recv[32 * 32 + GV_MAX_SPLITS];   // every split's sums of this block's share
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * GV_BN, n = n0 + 16 * g;
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + GV_KSTEP - 1) / GV_KSTEP;

  // acc[p]: D of mma p, columns n + 2 p (D rows g) and n + 2 p + 1 (g + 8)
  int acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[p][r] = 0;

  // the warp takes the block's steps warp, warp + GV_WARPS, ..., with
  // GV_DEPTH of them loading while one is summed
  uint4 w[GV_DEPTH][4];
  uint32_t xw[GV_DEPTH];
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d)
    gv_load_q<WIDE>(q, N, ke, kb + (warp + d * GV_WARPS) * GV_KSTEP + 4 * t, n, w[d]);
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d)
    xw[d] = gv_load_x<WIDE>(xq, M, K, ke, kb + (warp + d * GV_WARPS) * GV_KSTEP + 4 * t, g);
  for (int j0 = warp; j0 < steps; j0 += GV_DEPTH * GV_WARPS) {
#pragma unroll
    for (int d = 0; d < GV_DEPTH; ++d) {
      uint32_t col[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gv_transpose(word_of(w[d][0], i), word_of(w[d][1], i), word_of(w[d][2], i),
                     word_of(w[d][3], i), col + 4 * i);
#pragma unroll
      for (int p = 0; p < 8; ++p) mma_s8_16816(acc[p], col[2 * p], col[2 * p + 1], xw[d]);
      const int k0 = kb + (j0 + (d + GV_DEPTH) * GV_WARPS) * GV_KSTEP + 4 * t;
      gv_load_q<WIDE>(q, N, ke, k0, n, w[d]);
      xw[d] = gv_load_x<WIDE>(xq, M, K, ke, k0, g);
    }
  }

#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[warp][(4 * p + r) * 32 + lane] = acc[p][r];
  __syncthreads();
  // reduce-scatter over the cluster: block b owns the tile's elements
  // [b chunk, (b + 1) chunk) and receives every block's sums over its warps
  // for them; after one cluster barrier no block reads another's shared
  // memory, so each adds what it received, writes out and may exit.
  // Element e is register e / 32 of lane e % 32: p = e / 128, r = e / 32 % 4,
  // (g, t) = (e / 4 % 8, e % 4) -> row 2 t + r % 2, column 16 g + 2 p + r / 2.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int chunk = (32 * 32 + splits - 1) / splits;
  for (int e = tid; e < 32 * 32; e += GV_WARPS * 32) {
    int s = 0;
#pragma unroll
    for (int v = 0; v < GV_WARPS; ++v) s += part[v][e];
    cluster.map_shared_rank(recv, e / chunk)[rank * chunk + e % chunk] = s;
  }
  cluster.sync();
  const int e0 = rank * chunk, e1 = min(32 * 32, e0 + chunk);
  for (int e = e0 + tid; e < e1; e += GV_WARPS * 32) {
    const int r = (e >> 5) & 3;
    const int m = 2 * (e & 3) + (r & 1);
    const int c = n0 + 16 * ((e >> 2) & 7) + 2 * (e >> 7) + (r >> 1);
    if (m >= M || c >= N) continue;
    int s = 0;
#pragma unroll
    for (int b = 0; b < GV_MAX_SPLITS; ++b)
      if (b < splits) s += recv[b * chunk + e - e0];
    out[(size_t)m * N + c] = a8_out<TO>(s, sx[m], sw[c]);
  }
}

// ---------------------------------------------------------------------------
// W8A16 / W4A16 GEMV (M <= 8, bf16 x): qmm_a8_gemv's skeleton, with the
// weights made exact bf16 in registers for the bf16 mma.sync
// ---------------------------------------------------------------------------

constexpr int GV_KSTEP4 = 32;      // k rows of a W4 warp step: 16 packed rows, 4 a lane

// d (16x8 f32) += a (16x16 bf16) x b (16x8 bf16).  Lane (g, t) holds
// a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t, 2t + 1], a2 = A[g][2t + 8, 2t + 9],
// a3 = A[g + 8][2t + 8, 2t + 9], b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g],
// d as mma_s8_16816's
__device__ __forceinline__ void mma_bf16_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t x, uint32_t y) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bytes i of a and b (int8 values) -> their bf16x2, a's in the low half,
// exact: with s the sign bit and l the low 7 bits of a byte, its value is
// bf16(128 + l) - bf16(128 + 128 s), three numbers bf16 holds exactly
__device__ __forceinline__ uint32_t i8pair_bf16x2(uint32_t a, uint32_t b, int i) {
  const uint32_t p = __byte_perm(a, b, (uint32_t)(i | i << 4 | (4 + i) << 8 | (4 + i) << 12));
  return bf16x2_sub((p & 0x007F007Fu) | 0x43004300u, (p & 0x00800080u) | 0x43004300u);
}

// byte i of a packed int4 word w (w4 = w >> 4) -> the bf16x2 of its two
// signed nibbles, the low nibble (the even k row) in the low half, exact:
// with n a nibble's bits and u = n ^ 8, its value is bf16(128 + u) - bf16(136)
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t w, uint32_t w4, int i) {
  const uint32_t p = __byte_perm(w, w4, (uint32_t)(i | (4 + i) << 8));
  return bf16x2_sub(((p & 0x000F000Fu) | 0x43004300u) ^ 0x00080008u, 0x43084308u);
}

// One W8 warp step: the lane's pieces w (k rows 4t .. 4t + 3 of its 16
// columns) times x^T (xb: x[g][4t .. 4t + 3]).  A lane's k rows 4t, 4t + 1,
// 4t + 2, 4t + 3 are the k slots 2t, 2t + 1, 2t + 8, 2t + 9 of A and of B
// alike; mma p takes columns 2p and 2p + 1 as A's rows g and g + 8, so D
// register r of mma p is column 16 g + 2 p + r / 2 of row 2 t + r % 2.
__device__ __forceinline__ void a16_step_w8(float (&acc)[8][4], const uint4 (&w)[4],
                                            const uint2 (&xb)[1]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int wi = p >> 1, b0 = 2 * (p & 1);       // columns 2p, 2p + 1: bytes b0, b0 + 1
    const uint32_t r0 = word_of(w[0], wi), r1 = word_of(w[1], wi);
    const uint32_t r2 = word_of(w[2], wi), r3 = word_of(w[3], wi);
    mma_bf16_16816(acc[p], i8pair_bf16x2(r0, r1, b0), i8pair_bf16x2(r0, r1, b0 + 1),
                   i8pair_bf16x2(r2, r3, b0), i8pair_bf16x2(r2, r3, b0 + 1), xb[0].x, xb[0].y);
  }
}

// One W4 warp step, two mma k-chunks of 16 rows: chunk c's packed rows
// 8c + 2t and 8c + 2t + 1 (pieces w[2c], w[2c + 1]) hold its k rows
// 4t .. 4t + 3, the same k slots as a W8 step's, times xb[c].
__device__ __forceinline__ void a16_step_w4(float (&acc)[8][4], const uint4 (&w)[4],
                                            const uint2 (&xb)[2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      const uint32_t r0 = word_of(w[2 * c], wi), r1 = word_of(w[2 * c + 1], wi);
      const uint32_t s0 = r0 >> 4, s1 = r1 >> 4;
#pragma unroll
      for (int h = 0; h < 2; ++h)                  // mma 2 wi + h: bytes 2h, 2h + 1
        mma_bf16_16816(acc[2 * wi + h], nib_bf16x2(r0, s0, 2 * h), nib_bf16x2(r0, s0, 2 * h + 1),
                       nib_bf16x2(r1, s1, 2 * h), nib_bf16x2(r1, s1, 2 * h + 1), xb[c].x,
                       xb[c].y);
    }
}

// one lane's weight pieces of a warp step whose lane rows start at k row
// k0 (= the step's first row + 4 t): W8 rows k0 .. k0 + 3; W4 the packed
// rows of k rows k0, k0 + 2, k0 + 16, k0 + 18.  N % 16 == 0 and (W4) K and
// ke even, so a piece is all in or all out; out reads as zero.
template <int BITS>
__device__ __forceinline__ void a16_load_q(const int8_t* __restrict__ q, int N, int ke, int k0,
                                           int n, uint4 (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = BITS == 4 ? k0 + 2 * (i & 1) + 16 * (i >> 1) : k0 + i;
    w[i] = k < ke && n < N ? ldg_stream(q + (size_t)(BITS == 4 ? k >> 1 : k) * N + n)
                           : make_uint4(0, 0, 0, 0);
  }
}

// x[g][k .. k + 3] (k % 4 == 0) as two bf16x2 words, zero past ke and for
// rows g >= M; 4-byte loads where K is even (x is then 4-byte aligned, and
// so is ke), element loads where it is odd
__device__ __forceinline__ uint2 a16_load_x(const __nv_bfloat16* __restrict__ x, int M, int K,
                                            int ke, int k, int g) {
  if (g >= M) return make_uint2(0, 0);
  const unsigned short* row = reinterpret_cast<const unsigned short*>(x) + (size_t)g * K;
  if ((K & 1) == 0)
    return make_uint2(k < ke ? __ldg(reinterpret_cast<const unsigned*>(row + k)) : 0u,
                      k + 2 < ke ? __ldg(reinterpret_cast<const unsigned*>(row + k + 2)) : 0u);
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < ke) v[i >> 1] |= (uint32_t)__ldg(row + k + i) << (16 * (i & 1));
  return make_uint2(v[0], v[1]);
}

// grid (column tiles, splits), cluster (1, splits), as qmm_a8_gemv: block
// (x, y) sums k in [y k_per_split, min(K, (y + 1) k_per_split)) for
// columns 128 x .. 128 x + 127, and the cluster's blocks write the tile out
// together, each adding every split's sums for its share in rank order
template <int BITS>
__global__ void __launch_bounds__(GV_WARPS * 32)
qmm_a16_gemv(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int M, int N, int K,
             int k_per_split) {
  constexpr int KSTEP = BITS == 4 ? GV_KSTEP4 : GV_KSTEP;
  constexpr int XC = BITS == 4 ? 2 : 1;            // mma k-chunks of a step
  __shared__ float part[GV_WARPS][32 * 32];        // each warp's sums, [register][lane]
  __shared__ float recv[32 * 32 + GV_MAX_SPLITS];  // every split's sums of this block's share
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * GV_BN, n = n0 + 16 * g;
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + KSTEP - 1) / KSTEP;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[p][r] = 0.f;

  // the warp takes the block's steps warp, warp + GV_WARPS, ..., with
  // GV_DEPTH of them in flight while one is summed
  uint4 w[GV_DEPTH][4];
  uint2 xw[GV_DEPTH][XC];
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d)
    a16_load_q<BITS>(q, N, ke, kb + (warp + d * GV_WARPS) * KSTEP + 4 * t, n, w[d]);
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d)
#pragma unroll
    for (int c = 0; c < XC; ++c)
      xw[d][c] = a16_load_x(x, M, K, ke, kb + (warp + d * GV_WARPS) * KSTEP + 16 * c + 4 * t, g);
  for (int j0 = warp; j0 < steps; j0 += GV_DEPTH * GV_WARPS) {
#pragma unroll
    for (int d = 0; d < GV_DEPTH; ++d) {
      // this step's pieces, then the next loads, which go out before the
      // sums so that GV_DEPTH steps stay in flight (4-5 % on BLOOM's layers)
      uint4 cw[4];
      uint2 cx[XC];
#pragma unroll
      for (int i = 0; i < 4; ++i) cw[i] = w[d][i];
#pragma unroll
      for (int c = 0; c < XC; ++c) cx[c] = xw[d][c];
      const int k0 = kb + (j0 + (d + GV_DEPTH) * GV_WARPS) * KSTEP + 4 * t;
      a16_load_q<BITS>(q, N, ke, k0, n, w[d]);
#pragma unroll
      for (int c = 0; c < XC; ++c) xw[d][c] = a16_load_x(x, M, K, ke, k0 + 16 * c, g);
      if constexpr (BITS == 4) {
        // a step past the split's end is all zero: W4 skips its sums (3 %;
        // at W8 that is slower)
        if (j0 + d * GV_WARPS < steps) a16_step_w4(acc, cw, cx);
      } else {
        a16_step_w8(acc, cw, cx);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[warp][(4 * p + r) * 32 + lane] = acc[p][r];
  __syncthreads();
  // the reduce-scatter of qmm_a8_gemv, on float sums: each block adds its
  // warps in warp order, and the owner of an element adds the splits in
  // rank order, so every element's sum has one order whatever M is
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int chunk = (32 * 32 + splits - 1) / splits;
  for (int e = tid; e < 32 * 32; e += GV_WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < GV_WARPS; ++v) s += part[v][e];
    cluster.map_shared_rank(recv, e / chunk)[rank * chunk + e % chunk] = s;
  }
  cluster.sync();
  const int e0 = rank * chunk, e1 = min(32 * 32, e0 + chunk);
  for (int e = e0 + tid; e < e1; e += GV_WARPS * 32) {
    const int r = (e >> 5) & 3;
    const int m = 2 * (e & 3) + (r & 1);
    const int c = n0 + 16 * ((e >> 2) & 7) + 2 * (e >> 7) + (r >> 1);
    if (m >= M || c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < GV_MAX_SPLITS; ++b)
      if (b < splits) s += recv[b * chunk + e - e0];
    out[(size_t)m * N + c] = __float2bfloat16_rn(__fmul_rn(sw[c], s));
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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 prefill, W8A16 / W4A16): TMA -> mbarrier ring ->
// dequantize to a bf16 tile -> wgmma
// ---------------------------------------------------------------------------

constexpr int QT_BM = 128, QT_BN = 128, QT_BK = 64;   // output tile, k stage
constexpr int QT_STAGES = 4;
constexpr int QT_CONSUMERS = 256;                     // two warpgroups
constexpr int QT_THREADS = QT_CONSUMERS + 32;         // + one producer warp
constexpr int QT_X_BYTES = QT_BM * QT_BK * 2;         // 16 KB, 128B-swizzled
constexpr int QT_B_BYTES = QT_BK * QT_BN * 2;         // 16 KB bf16, N-major
constexpr int QT_Q_BYTES = QT_BK * QT_BN;             // 8 KB int8 (W4: 4 KB)
constexpr int QT_STAGE_BYTES = QT_X_BYTES + QT_B_BYTES + QT_Q_BYTES;
// + 1 KB to align the ring to the 1024-byte period of the 128B swizzle
constexpr int QT_SMEM = QT_STAGES * QT_STAGE_BYTES + 2 * QT_STAGES * 8 + 1024;
constexpr int QT_NAMED_BAR = 1;                       // 0 is __syncthreads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the barrier's phase differs from ``parity``
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory; bytes
// past the tensor's edge arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
       | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
       | (uint64_t)1 << 62;
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64x128 f32, this warpgroup's fragment) += A (64x16 bf16, K-major) x
// B (16x128 bf16, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// four small integers, one per byte of ``u`` and offset to be unsigned
// (u_i = v_i + bias - 2^23), to two bf16x2: each byte goes into the
// mantissa of 2^23 (a float32 whose low bits are the integer), the offset
// comes off in one exact subtraction, and |v_i| <= 128 rounds to bf16
// exactly
__device__ __forceinline__ uint2 bytes_to_bf16x4(uint32_t u, float bias) {
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - bias;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - bias;
  const float f2 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - bias;
  const float f3 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - bias;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f2, f3);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// the B tile: k row r (0..63), 8 consecutive columns starting at 8 * c8
// (c8 0..15).  Two 64-column halves of 8 KB, each row 128 bytes with its
// 16-byte chunks XOR-swizzled by r % 8 (the 128B swizzle's layout)
__device__ __forceinline__ uint32_t b_tile_offset(int r, int c8) {
  return (uint32_t)((c8 >> 3) * (QT_BK * 128) + r * 128 + (((c8 & 7) ^ (r & 7)) << 4));
}

// convert this consumer thread's share of a stage's weights to bf16
template <int MODE>
__device__ __forceinline__ void qt_convert(const uint8_t* qs, uint8_t* bs, int ct) {
  if constexpr (MODE == MODE_W4) {
    // 32 packed rows x 16 groups of 8 columns: two per thread
    const float bias = 8388608.f + 8.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = ct + QT_CONSUMERS * u, p = idx >> 4, c8 = idx & 15;
      const uint2 w = *reinterpret_cast<const uint2*>(qs + p * QT_BN + 8 * c8);
      const uint2 l0 = bytes_to_bf16x4((w.x & 0x0F0F0F0Fu) ^ 0x08080808u, bias);
      const uint2 l1 = bytes_to_bf16x4((w.y & 0x0F0F0F0Fu) ^ 0x08080808u, bias);
      const uint2 h0 = bytes_to_bf16x4(((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, bias);
      const uint2 h1 = bytes_to_bf16x4(((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, bias);
      *reinterpret_cast<uint4*>(bs + b_tile_offset(2 * p, c8)) =
          make_uint4(l0.x, l0.y, l1.x, l1.y);
      *reinterpret_cast<uint4*>(bs + b_tile_offset(2 * p + 1, c8)) =
          make_uint4(h0.x, h0.y, h1.x, h1.y);
    }
  } else {
    // 64 rows x 16 groups of 8 columns: four per thread
    const float bias = 8388608.f + 128.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = ct + QT_CONSUMERS * u, r = idx >> 4, c8 = idx & 15;
      const uint2 w = *reinterpret_cast<const uint2*>(qs + r * QT_BN + 8 * c8);
      const uint2 a = bytes_to_bf16x4(w.x ^ 0x80808080u, bias);
      const uint2 b = bytes_to_bf16x4(w.y ^ 0x80808080u, bias);
      *reinterpret_cast<uint4*>(bs + b_tile_offset(r, c8)) = make_uint4(a.x, a.y, b.x, b.y);
    }
  }
}

// B descriptor offsets (bytes), N-major: between the two 64-column halves
// (the leading offset) and between groups of 8 k rows (the stride offset)
constexpr uint32_t QT_B_LBO = QT_BK * 128;
constexpr uint32_t QT_B_SBO = 8 * 128;

template <int MODE>
__global__ void __launch_bounds__(QT_THREADS, 1)
qmm_tc(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap q_map,
       const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the ring, 1024-byte aligned; the barriers after it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + QT_STAGES * QT_STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + QT_STAGES);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * QT_BM, n0 = blockIdx.x * QT_BN;
  const int n_k = (K + QT_BK - 1) / QT_BK;
  constexpr int QROWS = MODE == MODE_W4 ? QT_BK / 2 : QT_BK;
  constexpr uint32_t TX = QT_X_BYTES + QROWS * QT_BN;

  if (tid == 0) {
    for (int s = 0; s < QT_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, QT_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= QT_CONSUMERS) {
    // producer: one thread keeps the ring full
    if (tid == QT_CONSUMERS) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % QT_STAGES;
        mbar_wait(empty0 + 8 * s, ((kt / QT_STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * QT_STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, TX);
        tma_load_2d(smem_u32(st), &x_map, kt * QT_BK, m0, full0 + 8 * s);
        tma_load_2d(smem_u32(st + QT_X_BYTES + QT_B_BYTES), &q_map, n0, kt * QROWS,
                    full0 + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64 wg ..
  const int wg = tid >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % QT_STAGES;
    uint8_t* st = ring + s * QT_STAGE_BYTES;
    mbar_wait(full0 + 8 * s, (kt / QT_STAGES) & 1);
    qt_convert<MODE>(st + QT_X_BYTES + QT_B_BYTES, st + QT_X_BYTES, tid);
    // the converted tile is read by the async proxy, and by both warpgroups
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "n"(QT_NAMED_BAR), "n"(QT_CONSUMERS) : "memory");
    const uint32_t xa = smem_u32(st) + wg * 64 * 128, ba = smem_u32(st + QT_X_BYTES);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < QT_BK / 16; ++j)
      wgmma_m64n128k16(acc, sw128_desc(xa + 32 * j, 16, 1024),
                       sw128_desc(ba + 16 * 128 * j, QT_B_LBO, QT_B_SBO));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the group before this one has completed: its stage goes back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    if (kt > 0) mbar_arrive(empty0 + 8 * ((kt - 1) % QT_STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // epilogue: the accumulator fragment of m64n128 -- register 4 c + 2 h + e
  // holds row 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int c = 0; c < QT_BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * (lane & 3);
    if (col >= N) continue;                 // N % 16 == 0: col + 1 < N too
    const float s0 = sw[col], s1 = sw[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(__fmul_rn(acc[4 * c + 2 * h], s0),
                                  __fmul_rn(acc[4 * c + 2 * h + 1], s1));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (W8A8 prefill): TMA -> mbarrier ring -> transpose the
// weight tile to K-major in shared memory -> int8 wgmma, exact int32 sums.
// Replaces _mm_kernel_w8a8 (src/repro/kernels/quant_matmul.py) at M > 8.
// ---------------------------------------------------------------------------

constexpr int A8_MT = 2;                              // m64 tiles per warpgroup
constexpr int A8_BM = 128 * A8_MT, A8_BN = 128, A8_BK = 128;   // tile; k stage (bytes)
constexpr int A8_STAGES = 3;
constexpr int A8_TILE = 128 * 128;                    // 16 KB
constexpr int A8_X_BYTES = A8_BM * A8_BK;
// a stage: the xq tile (TMA, 128B swizzle), the K-major B tile (written by
// the consumers), the raw q tile (TMA, plain row-major)
constexpr int A8_STAGE_BYTES = A8_X_BYTES + 2 * A8_TILE;
constexpr int A8_SMEM = A8_STAGES * A8_STAGE_BYTES + 2 * A8_STAGES * 8 + 1024;

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64x128 s32) += A (64x32 s8, K-major) x B (32x128 s8, K-major).  The
// integer form has no transpose immediates: both operands are K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// the K-major B tile: n row (0..127) of 128 k bytes, 16-byte chunk kc of k
// (0..7) XOR-swizzled by n % 8 (the 128B swizzle, as the xq tile's rows)
__device__ __forceinline__ uint32_t a8_kmajor_offset(int n, int kc) {
  return (uint32_t)(n * 128 + ((kc ^ (n & 7)) << 4));
}

// the raw q tile as the TMA writes it: k row of 128 n bytes, plain
__device__ __forceinline__ uint32_t a8_raw_offset(int k, int n) {
  return (uint32_t)(k * 128 + n);
}

// one consumer thread's share of the stage's transpose: the 4 columns
// n = 4 lane .. 4 lane + 3 over the 16 k rows of chunk kc = warp ^ (lane % 8).
// 16 word reads (the 32 lanes read the 32 words of a row position, so 32
// banks), a 4x4 byte transpose per 4 rows with
// __byte_perm, and 4 16-byte writes (the kc of a quarter warp's 8 lanes
// differ, so they cover the 8 chunk positions of the swizzled rows).
__device__ __forceinline__ void a8_transpose(const uint8_t* raw, uint8_t* bt, int ct) {
  const int lane = ct & 31, kc = (ct >> 5) ^ (lane & 7), n0 = 4 * lane;
  uint32_t r[16];
#pragma unroll
  for (int t = 0; t < 16; ++t)
    r[t] = *reinterpret_cast<const uint32_t*>(raw + a8_raw_offset(16 * kc + t, n0));
  uint32_t col[4][4];                    // col[i][j]: column n0 + i, k rows 4 j ..
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo01 = __byte_perm(r[4 * j], r[4 * j + 1], 0x5140);      // a0 b0 a1 b1
    const uint32_t hi01 = __byte_perm(r[4 * j], r[4 * j + 1], 0x7362);      // a2 b2 a3 b3
    const uint32_t lo23 = __byte_perm(r[4 * j + 2], r[4 * j + 3], 0x5140);  // c0 d0 c1 d1
    const uint32_t hi23 = __byte_perm(r[4 * j + 2], r[4 * j + 3], 0x7362);  // c2 d2 c3 d3
    col[0][j] = __byte_perm(lo01, lo23, 0x5410);                            // a0 b0 c0 d0
    col[1][j] = __byte_perm(lo01, lo23, 0x7632);                            // a1 b1 c1 d1
    col[2][j] = __byte_perm(hi01, hi23, 0x5410);
    col[3][j] = __byte_perm(hi01, hi23, 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint4*>(bt + a8_kmajor_offset(n0 + i, kc)) =
        make_uint4(col[i][0], col[i][1], col[i][2], col[i][3]);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <typename TO>
__global__ void __launch_bounds__(QT_THREADS, 1)
qmm_a8_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap q_map,
             const float* __restrict__ sx, const float* __restrict__ sw, TO* __restrict__ out,
             int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + A8_STAGES * A8_STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + A8_STAGES);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * A8_BM, n0 = blockIdx.x * A8_BN;
  const int n_k = (K + A8_BK - 1) / A8_BK;

  if (tid == 0) {
    for (int s = 0; s < A8_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, QT_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= QT_CONSUMERS) {
    // producer: one thread keeps the ring full
    if (tid == QT_CONSUMERS) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % A8_STAGES;
        mbar_wait(empty0 + 8 * s, ((kt / A8_STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * A8_STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, A8_X_BYTES + A8_TILE);
        tma_load_2d(smem_u32(st), &x_map, kt * A8_BK, m0, full0 + 8 * s);
        tma_load_2d(smem_u32(st + A8_X_BYTES + A8_TILE), &q_map, n0, kt * A8_BK,
                    full0 + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64 A8_MT wg ..
  const int wg = tid >> 7;
  int acc[A8_MT][64];
#pragma unroll
  for (int t = 0; t < A8_MT; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % A8_STAGES;
    uint8_t* st = ring + s * A8_STAGE_BYTES;
    mbar_wait(full0 + 8 * s, (kt / A8_STAGES) & 1);
    a8_transpose(st + A8_X_BYTES + A8_TILE, st + A8_X_BYTES, tid);
    // the K-major tile is read by the async proxy, and by both warpgroups
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "n"(QT_NAMED_BAR), "n"(QT_CONSUMERS) : "memory");
    const uint32_t xa = smem_u32(st) + wg * A8_MT * 64 * 128,
                   ba = smem_u32(st + A8_X_BYTES);
#pragma unroll
    for (int t = 0; t < A8_MT; ++t) fence_acc(acc[t]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < A8_BK / 32; ++j)
#pragma unroll
      for (int t = 0; t < A8_MT; ++t)
        wgmma_m64n128k32_s8(acc[t], sw128_desc(xa + t * 64 * 128 + 32 * j, 16, 1024),
                            sw128_desc(ba + 32 * j, 16, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the group before this one has completed: its stage goes back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
#pragma unroll
    for (int t = 0; t < A8_MT; ++t) fence_acc(acc[t]);
    if (kt > 0) mbar_arrive(empty0 + 8 * ((kt - 1) % A8_STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int t = 0; t < A8_MT; ++t) fence_acc(acc[t]);

  // epilogue, a8_out in the plain version's order; the fragment layout is
  // qmm_tc's (register 4 c + 2 h + e: row 16 warp + lane / 4 + 8 h, column
  // 8 c + 2 (lane % 4) + e)
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int t = 0; t < A8_MT; ++t) {
    const int row0 = m0 + (wg * A8_MT + t) * 64 + warp * 16 + (lane >> 2);
    float sr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sr[h] = row0 + 8 * h < M ? sx[row0 + 8 * h] : 0.f;
#pragma unroll
    for (int c = 0; c < A8_BN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * (lane & 3);
      if (col >= N) continue;               // N % 16 == 0: col + 1 < N too
      const float s0 = sw[col], s1 = sw[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          store_pair(out + (size_t)row * N + col, a8_out<TO>(acc[t][4 * c + 2 * h], sr[h], s0),
                     a8_out<TO>(acc[t][4 * c + 2 * h + 1], sr[h], s1));
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major (rows, cols) tensor read in (box_rows, box_cols) boxes
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
               int cols, int elem_bytes, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch_tc(const void* x, const int8_t* q, const float* sw, void* out, int M, int N,
              int K, cudaStream_t stream) {
  const int q_rows = MODE == MODE_W4 ? (K + 1) / 2 : K;
  alignas(64) CUtensorMap x_map, q_map;
  if (!encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, QT_BM, QT_BK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, q_rows, N, 1,
                 MODE == MODE_W4 ? QT_BK / 2 : QT_BK, QT_BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaFuncSetAttribute(
      qmm_tc<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, QT_SMEM);
  if (rc != 0) return rc;
  dim3 grid((N + QT_BN - 1) / QT_BN, (M + QT_BM - 1) / QT_BM);
  qmm_tc<MODE><<<grid, QT_THREADS, QT_SMEM, stream>>>(
      x_map, q_map, sw, static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_a8_tc(const void* xq, const float* sx, const int8_t* q, const float* sw, void* out,
                 int M, int N, int K, cudaStream_t stream) {
  alignas(64) CUtensorMap x_map, q_map;
  if (!encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, 1, A8_BM, A8_BK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, 1, A8_BK, A8_BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaFuncSetAttribute(
      qmm_a8_wgmma<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, A8_SMEM);
  if (rc != 0) return rc;
  dim3 grid((N + A8_BN - 1) / A8_BN, (M + A8_BM - 1) / A8_BM);
  qmm_a8_wgmma<TO><<<grid, QT_THREADS, A8_SMEM, stream>>>(
      x_map, q_map, sx, sw, static_cast<TO*>(out), M, N, K);
  return (int)cudaGetLastError();
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

template <typename TO, bool WIDE>
int launch_a8_gemv(const int8_t* xq, const float* sx, const int8_t* q, const float* sw, void* out,
                   int M, int N, int K, int splits, int k_per_split, cudaStream_t stream) {
  if (splits < 1 || splits > GV_MAX_SPLITS || k_per_split % GV_KSTEP != 0 ||
      (long long)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GV_BN - 1) / GV_BN, splits);
  cfg.blockDim = dim3(GV_WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_a8_gemv<TO, WIDE>, xq, sx, q, sw,
                                           static_cast<TO*>(out), M, N, K, k_per_split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_a16_gemv(const void* x, const int8_t* q, const float* sw, void* out, int M, int N,
                    int K, int splits, int k_per_split, cudaStream_t stream) {
  constexpr int KSTEP = BITS == 4 ? GV_KSTEP4 : GV_KSTEP;
  if (M < 1 || M > GV_ROWS || N % 16 != 0 || (BITS == 4 && K % 2 != 0) || splits < 1 ||
      splits > GV_MAX_SPLITS || k_per_split % KSTEP != 0 || (long long)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GV_BN - 1) / GV_BN, splits);
  cfg.blockDim = dim3(GV_WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_a16_gemv<BITS>,
                                           static_cast<const __nv_bfloat16*>(x), q, sw,
                                           static_cast<__nv_bfloat16*>(out), M, N, K, k_per_split);
  if (e != cudaSuccess) return (int)e;
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

// W8A16 (bits 8) / W4A16 (bits 4) at M <= 8 with bfloat16 x and out:
// qmm_a16_gemv over ``splits`` blocks of k_per_split (a multiple of 16, or
// 32 for bits 4) per column tile.  N % 16 == 0, K even for bits 4, q 16-byte
// and x 4-byte aligned.
int qmm_a16_gemv(const void* x, const void* q, const void* scale, void* out, int M, int N,
                 int K, int bits, int splits, int k_per_split, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  return bits == 4 ? launch_a16_gemv<4>(x, qp, sp, out, M, N, K, splits, k_per_split, st)
                   : launch_a16_gemv<8>(x, qp, sp, out, M, N, K, splits, k_per_split, st);
}

// W8A16 (bits 8) / W4A16 (bits 4) on the tensor cores: x and out bfloat16,
// K % 8 == 0, N % 16 == 0, and x, q 16-byte aligned (the TMA's rules).
int qmm_a16_tc(const void* x, const void* q, const void* scale, void* out,
               int M, int N, int K, int bits, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  return bits == 4 ? launch_tc<MODE_W4>(x, qp, sp, out, M, N, K, st)
                   : launch_tc<MODE_W8>(x, qp, sp, out, M, N, K, st);
}

// W8A8: xq int8 (M, K) with row scales sx (M,) float32; out float32
// (out_bf16 = 0) or bfloat16 (1).  M <= 8: qmm_a8_gemv over ``splits``
// blocks of k_per_split (a multiple of GV_KSTEP) per column tile, 16-byte
// loads where ``wide`` (N % 16 == 0, K % 4 == 0, q 16-byte and xq 4-byte
// aligned); M > 8: the tiled kernel.
int qmm_a8(const void* xq, const void* sx, const void* q, const void* sw,
           void* out, int M, int N, int K, int out_bf16, int wide,
           int splits, int k_per_split, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(xq);
  auto qp = static_cast<const int8_t*>(q);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  if (M <= GV_ROWS) {
    if (out_bf16)
      return wide ? launch_a8_gemv<__nv_bfloat16, true>(xp, sxp, qp, swp, out, M, N, K, splits, k_per_split, st)
                  : launch_a8_gemv<__nv_bfloat16, false>(xp, sxp, qp, swp, out, M, N, K, splits, k_per_split, st);
    return wide ? launch_a8_gemv<float, true>(xp, sxp, qp, swp, out, M, N, K, splits, k_per_split, st)
                : launch_a8_gemv<float, false>(xp, sxp, qp, swp, out, M, N, K, splits, k_per_split, st);
  }
  dim3 grid((N + TL_BN - 1) / TL_BN, (M + TL_BM - 1) / TL_BM);
  if (out_bf16)
    qmm_tiled<MODE_A8, int8_t, __nv_bfloat16><<<grid, TL_THREADS, 0, st>>>(
        xp, sxp, qp, swp, static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    qmm_tiled<MODE_A8, int8_t, float><<<grid, TL_THREADS, 0, st>>>(
        xp, sxp, qp, swp, static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// W8A8 on the tensor cores (M > 8): as qmm_a8, with K % 16 == 0, N % 16 == 0
// and xq, q 16-byte aligned (the TMA's rules).
int qmm_a8_tc(const void* xq, const void* sx, const void* q, const void* sw, void* out,
              int M, int N, int K, int out_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  return out_bf16 ? launch_a8_tc<__nv_bfloat16>(xq, sxp, qp, swp, out, M, N, K, st)
                  : launch_a8_tc<float>(xq, sxp, qp, swp, out, M, N, K, st);
}

}  // extern "C"

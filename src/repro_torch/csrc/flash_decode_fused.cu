// Fused quantized decode attention for Hopper (sm_90a), over a slot cache
// (K6) or through a block table over a page arena (K7).
//
// K6 replaces the Pallas TPU kernel _fused_body (with _qproject and
// _rot_half) of src/repro/kernels/flash_decode.py, wrapper
// repro/kernels/ops.py flash_decode_fused; K7 replaces _fused_paged_body
// (wrapper flash_decode_fused_paged).  One decode-attention step from the
// hidden rows x (B, D) and the int8 projections wq (D, nh*dh), wk/wv
// (D, nkv*dh), wo (nh*dh, D), each with a float32 scale per column:
//
//   1. project q (the G = nh / nkv heads of one KV head), k1 and v1 from x.
//      a16: float32 sums of x * w, times the column scale s[c] after the
//      sum.  a8: x is quantized per row (sx = absmax * float32(1/127),
//      x / sx rounded half to even, clipped to [-128, 127]), summed exactly
//      in int32 and rescaled once, acc * sx * s[c];
//   2. rotate q and k1 by the rope rows cos/sin (1, dh/2), split halves;
//   3. online softmax in float32 over the PRE-write cache: slots >=
//      n_valid[b] and the slot evict[b] (the one the current token will
//      overwrite once the window has wrapped; -1: none) are masked;
//   4. the current token (its float32 k1/v1) folded in as the last step,
//      then attn = acc / max(l, 1e-30);
//   5. the head group's attn (G * dh; a8: quantized as ONE row of G * dh,
//      as the TPU kernel does) through its wo tile into a float32 partial
//      o_h (D,) per row.
// k1/v1 are written in x's type; the caller writes them into the cache.
// The TPU grid sums the partials into its output block across the KV-head
// axis in x's type: o = T(o_0); o = T(o + T(o_h)) for h = 1, 2, ....  Here
// the partials go to a float32 workspace and a second small kernel sums
// them in that same order: deterministic, no atomics.
//
// What bounds it on an H100: the bytes.  The four int8 projection matrices
// plus the valid cache slots, 2 * B * n_valid * nkv * dh * sizeof(T),
// against 3.35 TB/s: at BLOOM-7B1's decode shape (B = 8, D = 4096, 32
// heads of 128, n_valid 576, bf16) 67.1 MB of weights and 75.5 MB of cache,
// 142.9 MB, 0.0427 ms.  The arithmetic is about 2 operations per weight byte
// per row, far below the tensor cores' rate.
//
// Design.  Every weight byte is read from device memory once per call and
// used for all rows of x: the projections are skinny GEMMs over up to
// FU_ROWS = 8 rows (more rows: one launch per group of 8), not B GEMVs.
// One thread-block cluster of C blocks per KV head (C from nkv alone,
// flash_decode.fused_plan: 4 at nkv = 32, 128 blocks for the card's 132
// SMs), 256 threads a block, at most 128 registers a thread so that two
// blocks may share an SM (one block an SM would fit only 30 clusters of 4):
//   a. q/k/v.  Block r of the cluster sums D rows [r kpb, (r + 1) kpb) for
//      the head's (G + 2) * dh columns.  Each lane reads its 4 k rows x 16
//      columns of int8 weights in 16-byte pieces, FU_DEPTH warp steps in
//      flight, and feeds mma.sync m16n8k16 with A = W^T and B = x^T (8 rows,
//      zero past B): int8 x int8 -> int32 (a8: 4x4 __byte_perm transposes,
//      the layout of quant_matmul.cu's qmm_a8_gemv) or bf16 x bf16 -> float32
//      (a16 with bf16 x: each int8 made an exact bf16 in registers as
//      bf16(128 + low 7 bits) - bf16(128 + 128 sign), the k slots of a
//      lane's rows 4t .. 4t + 3 being 2t, 2t + 1, 2t + 8, 2t + 9 for A and
//      B alike).  a8 quantizes x per row with the whole row's maximum: each
//      block takes its slice's maxima, the cluster's blocks exchange them
//      through distributed shared memory behind one cluster barrier.  The
//      warps of a block split the k steps and add their tiles in warp
//      order; each block then writes the sums of row m into the shared
//      memory of the block that owns row m (m mod C); one cluster barrier,
//      and the owner adds the C blocks' sums in rank order, scales, ropes
//      and writes k1/v1.  float32 x (reduced models) and widths 16-byte
//      loads cannot take run the same partition on CUDA cores.
//   b. attention.  Each block attends its own rows, one after the other:
//      64-slot tiles of K and V copied to shared memory by 16-byte cp.async
//      (element loads where the strides forbid it), FU_STAGES - 1 tiles
//      ahead (one where shared memory is short).  Warp w takes slots
//      8w .. 8w + 7 of every tile with its own running max, denominator and
//      P.V sums: lanes over d_head, the 8 scores reduced by one fixed
//      butterfly, one exponential a lane; one block barrier a tile, for the
//      copies.  At the row's end the warps merge in warp order, the current
//      token comes last, and the row's attention is kept as wo takes it
//      (a8: quantized per row of G * dh).
//   c. wo.  After a second cluster barrier every block reads every row's
//      attention from its owner, and takes wo columns [r wcols,
//      (r + 1) wcols) of the head's G * dh rows for all rows of x on the
//      same mma steps (a16: attn as bf16 hi + lo parts, two mma, about 16
//      bits of its float32 value); its first weight steps go out before the
//      barrier.  Each warp's tile goes out through shared memory in
//      contiguous rows of the float32 partial.
// Nothing in the partition depends on B or on the values: each row's o,
// k1 and v1 are a function of its own x, cache and n_valid, bitwise the
// same alone and in a batch, and every float sum has one fixed order.
//
// What holds it above the bound (H100, probe variants of this kernel,
// PERF.md section 6): one block an SM streams each phase's bytes at about
// half of the SM's share of the card's rate, the phases in series; and the
// 32 clusters leave 8 SMs with two blocks, which finish last.
//
// K7 is the same body templated on a block-table address functor, as K5
// is K4's (csrc/flash_decode.cu): slot s of row b lives in page
// table[b, s / bt] at offset s % bt, with page, slot and head strides as
// arguments, so the leading (nkv, dh) corner of a wider page tail is read
// in place, and K7 equals K6 bitwise on the same values.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int FU_THREADS = 256;
constexpr int FU_WARPS = FU_THREADS / 32;
constexpr int FU_ROWS = 8;          // rows of x a launch takes: the mma's n
constexpr int FU_KSTEP = 16;        // k rows of a warp step: 4 lanes x 4 rows
constexpr int FU_BN = 128;          // columns of a warp tile: 8 lane groups x 16
constexpr int FU_DEPTH = 2;         // warp steps in flight per warp
constexpr int FU_BS = 64;           // cache slots of an attention tile
constexpr int FU_STAGES = 3;        // attention tiles in shared memory (2 where short)
constexpr size_t FU_SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int FU_MAX_CLUSTER = 8;   // blocks of a cluster (the portable limit)
constexpr int FU_TILE = 32 * 32;    // a warp tile's sums: 32 registers x 32 lanes
constexpr int FU_WOS = FU_BN + 4;   // row stride (floats) of a wo tile in shared memory
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(FU_WARPS == FU_ROWS, "x's row maxima take one warp a row");
static_assert(FU_STAGES >= 2, "a tile in flight while one is read");

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

// ---------------------------------------------------------------------------
// Shared memory.  The first region serves three phases: the projection's
// x slice, warp tiles and received sums; the attention's cache ring; the wo
// tiles on their way out.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {                      // byte offsets into dynamic shared memory
  size_t xs, part, recv, ring, aall, own, stat, acc, attn, oatt, osx, asx, sx, xmax, info, red,
      total;
};

// xelt: bytes of an x element in the slice (a8 int8, a16 bf16 for the mma,
// float otherwise); aelt: bytes a row's attention takes per value
__host__ __device__ inline Layout layout(int C, int G, int dh, int kpb, int elt, bool a8,
                                         bool mma, int stages) {
  const int Gd = G * dh, NC = Gd + 2 * dh, R = (FU_ROWS + C - 1) / C;
  const size_t xelt = a8 ? 1 : (mma ? 2 : 4), aelt = a8 ? 1 : 4;
  Layout L;
  L.xs = 0;
  L.part = al16((size_t)FU_ROWS * kpb * xelt);
  // the warp tiles (mma), and a8's float slice before the cluster's maxima
  const size_t tiles = mma ? (size_t)FU_WARPS * FU_TILE * 4 : 0;
  const size_t raw = a8 ? (size_t)FU_ROWS * kpb * 4 : 0;
  L.recv = L.part + al16(tiles > raw ? tiles : raw);
  const size_t proj = L.recv + al16((size_t)C * R * NC * 4);
  L.ring = 0;
  const size_t ring = (size_t)stages * 2 * FU_BS * dh * elt;
  // the wo phase: the warps' output tiles (mma), then every row's attention
  L.aall = al16(mma ? (size_t)FU_WARPS * FU_ROWS * FU_WOS * 4 : 0);
  const size_t wo = L.aall + al16((size_t)FU_ROWS * Gd * aelt);
  size_t o = al16(proj > ring ? proj : ring);
  o = o > wo ? o : wo;
  L.own = o;  o += al16((size_t)R * NC * 4);            // q, k1, v1 of own rows
  L.stat = o; o += al16((size_t)(3 * FU_WARPS + 3) * G * 4);  // per warp m, l, weight;
                                                        // alpha, p_cur, l of the row
  L.acc = o;  o += al16((size_t)FU_WARPS * Gd * 4);     // each warp's P.V sums
  L.attn = o; o += al16((size_t)Gd * 4);                // the row's attention
  L.oatt = o; o += al16((size_t)R * Gd * aelt);         // own rows', as wo takes it
  L.osx = o;  o += al16((size_t)R * 4);                 // a8: their scales
  L.asx = o;  o += al16(FU_ROWS * 4);                   // a8: every row's scale
  L.sx = o;   o += al16(FU_ROWS * 4);                   // a8: x row scales
  L.xmax = o; o += al16((FU_MAX_CLUSTER + 1) * FU_ROWS * 4);  // a8: each block's row maxima
  L.info = o; o += al16((size_t)3 * R * 4);             // n_valid, evict, tiles
  L.red = o;  o += al16((FU_WARPS + 1) * 4);            // a block maximum
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// Cache addressing: element offset of (row b, logical slot s, kv head h,
// d = 0) in k and v
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Warp steps on the tensor cores
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
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
// Lane (g, t) holds a0 = A[g][4t ..], a1 = A[g + 8][4t ..], b = B[4t ..][g],
// d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]) : "r"(a0), "r"(a1), "r"(b));
}

// d (16x8 f32) += a (16x16 bf16) x b (16x8 bf16).  Lane (g, t) holds
// a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t, 2t + 1], a2 = A[g][2t + 8, 2t + 9],
// a3 = A[g + 8][2t + 8, 2t + 9], b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g],
// d as mma_s8's
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bytes i of a and b (int8 values) -> their bf16x2, a's in the low half,
// exact: with s the sign bit and l the low 7 bits of a byte, its value is
// bf16(128 + l) - bf16(128 + 128 s), three numbers bf16 holds exactly
__device__ __forceinline__ uint32_t i8pair_bf16x2(uint32_t a, uint32_t b, int i) {
  const uint32_t p = __byte_perm(a, b, (uint32_t)(i | i << 4 | (4 + i) << 8 | (4 + i) << 12));
  const uint32_t x = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t y = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One warp step: the lane's weights w (k rows 4t .. 4t + 3 of its 16
// columns 16 g .. 16 g + 15) times B^T.  mma p takes columns 2p and 2p + 1
// as A's rows g and g + 8, so D register r of mma p is column
// 16 g + 2 p + r / 2 of row 2 t + r % 2 (mma_tile_element).
__device__ __forceinline__ void step_s8(int (&acc)[8][4], const uint4 (&w)[4], uint32_t xb) {
  uint32_t col[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    transpose4(word_of(w[0], i), word_of(w[1], i), word_of(w[2], i), word_of(w[3], i),
               col + 4 * i);
#pragma unroll
  for (int p = 0; p < 8; ++p) mma_s8(acc[p], col[2 * p], col[2 * p + 1], xb);
}

// The bf16 step: k rows 4t, 4t + 1, 4t + 2, 4t + 3 of the lane are the k
// slots 2t, 2t + 1, 2t + 8, 2t + 9 of A and of B (xh: the lane's 4 values
// of x^T).  With LO a second B (xl) is summed on the same A.
template <bool LO>
__device__ __forceinline__ void step_bf16(float (&acc)[8][4], const uint4 (&w)[4], uint2 xh,
                                          uint2 xl) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int wi = p >> 1, b0 = 2 * (p & 1);       // columns 2p, 2p + 1: bytes b0, b0 + 1
    const uint32_t r0 = word_of(w[0], wi), r1 = word_of(w[1], wi);
    const uint32_t r2 = word_of(w[2], wi), r3 = word_of(w[3], wi);
    const uint32_t a0 = i8pair_bf16x2(r0, r1, b0), a1 = i8pair_bf16x2(r0, r1, b0 + 1);
    const uint32_t a2 = i8pair_bf16x2(r2, r3, b0), a3 = i8pair_bf16x2(r2, r3, b0 + 1);
    mma_bf16(acc[p], a0, a1, a2, a3, xh.x, xh.y);
    if (LO) mma_bf16(acc[p], a0, a1, a2, a3, xl.x, xl.y);
  }
}

// element e = 32 register + lane of a warp tile -> (row of x, column of the
// 128-column tile)
__device__ __forceinline__ void mma_tile_element(int e, int& m, int& c) {
  const int r = (e >> 5) & 3;
  m = 2 * (e & 3) + (r & 1);
  c = 16 * ((e >> 2) & 7) + 2 * (e >> 7) + (r >> 1);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct FusedArgs {
  const void* x;
  const int8_t *wq, *wk, *wv, *wo;
  const float *sq, *sk, *sv, *so;
  const void *k, *v;
  const int *n_valid, *evict;
  int nv_scalar, ev_scalar;
  const float *cos, *sin;
  void *k1, *v1;
  float* part;                       // (B, nkv, D) float32
  int B, D, nh, nkv, dh, W;
  int row0;                          // this launch's first row
  int kpb, wcols;                    // D rows and wo columns of a block
  float scale, inv127;
  int use_rope, wide_kv;
  int stages;                        // attention tiles in shared memory
};

// column c of the head's (G + 2) dh q/k/v columns: its weight column (row
// stride ld) and scale
__device__ __forceinline__ const int8_t* qkv_col(const FusedArgs& a, int h, int Gd, int c,
                                                 int& ld, const float*& s) {
  if (c < Gd) {
    ld = a.nh * a.dh;
    s = a.sq + h * Gd + c;
    return a.wq + h * Gd + c;
  }
  ld = a.nkv * a.dh;
  const int ck = c - Gd;
  if (ck < a.dh) {
    s = a.sk + h * a.dh + ck;
    return a.wk + h * a.dh + ck;
  }
  s = a.sv + h * a.dh + ck - a.dh;
  return a.wv + h * a.dh + ck - a.dh;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// int8 of v / sx, rounded half to even and clipped, as quantize_rowwise
__device__ __forceinline__ int8_t quant8(float v, float sx) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -128.f), 127.f);
}

constexpr int FU_SPW = FU_BS / FU_WARPS;   // slots of a tile a warp takes
static_assert(FU_SPW == 8, "the score butterfly takes 8 slots a warp");

// DPL consecutive values at p (shared memory, aligned to their size) as float
template <int DPL, typename T>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[DPL]) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (DPL == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xffff0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xffff0000u);
    } else if constexpr (DPL == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
      v[0] = __uint_as_float(u << 16);
      v[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      v[0] = to_f32(p[0]);
    }
  } else if constexpr (DPL == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (DPL == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

template <int DPL>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[DPL]) {
  if constexpr (DPL == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (DPL == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else p[0] = v[0];
}

// One warp's share of a cache tile, for every head: its nj slots (logical
// slots sbase ..), their scores (a fixed xor tree), the online-softmax step
// on the warp's running max wm and denominator wl, and P.V into wacc
// (G, dh).  Lane l takes the d_head values l DPL .. l DPL + DPL - 1 (DPL =
// dh / 32), or with DPL = 0 the values l, l + 32, ....
template <int DPL, typename T>
__device__ __forceinline__ void warp_tile(const T* kw, const T* vw, int nj, int sbase, int ev,
                                          const float* q, float* wacc, float* wm, float* wl,
                                          int G, int dh, int lane) {
  for (int gg = 0; gg < G; ++gg) {
    const float* qg = q + gg * dh;
    float* ag = wacc + gg * dh;
    float sj[FU_SPW];
    if constexpr (DPL > 0) {
      float qr[DPL];
      load_vals<DPL>(qg + lane * DPL, qr);
#pragma unroll
      for (int jj = 0; jj < FU_SPW; ++jj) {
        float part = 0.f;
        if (jj < nj) {
          float kv[DPL];
          load_vals<DPL>(kw + jj * dh + lane * DPL, kv);
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qr[i], kv[i], part);
        }
        sj[jj] = part;
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < FU_SPW; ++jj) {
        float part = 0.f;
        if (jj < nj)
          for (int d = lane; d < dh; d += 32) part = fmaf(qg[d], to_f32(kw[jj * dh + d]), part);
        sj[jj] = part;
      }
    }
    // the 8 sums over the lanes by a fixed butterfly: lane l ends with the
    // sum of slot sl = 4 l4 + 2 l3 + l2 (lane bits 4, 3, 2)
    const bool l4 = lane & 16, l3 = lane & 8, l2 = lane & 4;
    float r4[4], r2[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r4[k] = (l4 ? sj[k + 4] : sj[k]) + __shfl_xor_sync(FULL, l4 ? sj[k] : sj[k + 4], 16);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      r2[k] = (l3 ? r4[k + 2] : r4[k]) + __shfl_xor_sync(FULL, l3 ? r4[k] : r4[k + 2], 8);
    float r1 = (l2 ? r2[1] : r2[0]) + __shfl_xor_sync(FULL, l2 ? r2[0] : r2[1], 4);
    r1 += __shfl_xor_sync(FULL, r1, 2);
    r1 += __shfl_xor_sync(FULL, r1, 1);
    const int sl = (l4 ? 4 : 0) | (l3 ? 2 : 0) | (l2 ? 1 : 0);
    // the online-softmax step: one slot's exponential a lane, then the
    // warp's max and sum over its 8 slots (fixed xor trees)
    const bool ok = sl < nj && sbase + sl != ev;
    float mx = ok ? r1 : NEG;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_old = wm[gg], m_new = fmaxf(m_old, mx);
    const float pl = ok ? expf(r1 - m_new) : 0.f;
    float sum = pl;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
    const float al = expf(m_old - m_new);
#pragma unroll
    for (int jj = 0; jj < FU_SPW; ++jj)
      sj[jj] = __shfl_sync(FULL, pl, (jj & 4 ? 16 : 0) | (jj & 2 ? 8 : 0) | (jj & 1 ? 4 : 0));
    // P.V, the warp's slots in order
    if constexpr (DPL > 0) {
      float av[DPL];
      load_vals<DPL>(ag + lane * DPL, av);
#pragma unroll
      for (int i = 0; i < DPL; ++i) av[i] *= al;
#pragma unroll
      for (int jj = 0; jj < FU_SPW; ++jj)
        if (jj < nj) {
          float vv[DPL];
          load_vals<DPL>(vw + jj * dh + lane * DPL, vv);
#pragma unroll
          for (int i = 0; i < DPL; ++i) av[i] = fmaf(sj[jj], vv[i], av[i]);
        }
      store_vals<DPL>(ag + lane * DPL, av);
    } else {
      for (int d = lane; d < dh; d += 32) {
        float o = ag[d] * al;
#pragma unroll
        for (int jj = 0; jj < FU_SPW; ++jj)
          if (jj < nj) o = fmaf(sj[jj], to_f32(vw[jj * dh + d]), o);
        ag[d] = o;
      }
    }
    __syncwarp();
    if (lane == 0) {
      wm[gg] = m_new;
      wl[gg] = al * wl[gg] + sum;
    }
    __syncwarp();
  }
}

// grid (C, nkv), cluster (C, 1, 1): block r of KV head h's cluster; rows
// row0 .. row0 + min(8, B - row0) - 1
template <typename T, bool A8, bool MMA, typename Addr>
__global__ void __launch_bounds__(FU_THREADS, 2)
fused_decode(FusedArgs a, Addr addr) {
  using AccT = typename std::conditional<A8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int D = a.D, dh = a.dh, nkv = a.nkv, G = a.nh / nkv;
  const int Gd = G * dh, NC = Gd + 2 * dh, half = dh / 2;
  const int Bg = min(FU_ROWS, a.B - a.row0), R = (FU_ROWS + C - 1) / C;
  const int Rv = rank < Bg ? (Bg - rank + C - 1) / C : 0;     // own rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kpb = a.kpb, kb = rank * kpb, ke = min(D, kb + kpb);
  const int S = a.stages;
  const Layout L = layout(C, G, dh, kpb, (int)sizeof(T), A8, MMA, S);
  float* recv = reinterpret_cast<float*>(smem + L.recv);       // [C][R][NC]
  float* own = reinterpret_cast<float*>(smem + L.own);         // [R][NC]
  float* st_m = reinterpret_cast<float*>(smem + L.stat);      // [FU_WARPS][G]
  float* st_l = st_m + FU_WARPS * G;                           // [FU_WARPS][G]
  float* st_w = st_l + FU_WARPS * G;                           // [G][FU_WARPS]
  float* st_a = st_w + FU_WARPS * G;                           // [G]
  float* st_p = st_a + G;
  float* st_f = st_p + G;
  float* acc = reinterpret_cast<float*>(smem + L.acc);         // [FU_WARPS][G dh]
  float* attn = reinterpret_cast<float*>(smem + L.attn);       // [G dh]
  float* osx = reinterpret_cast<float*>(smem + L.osx);
  float* asx = reinterpret_cast<float*>(smem + L.asx);
  float* sx = reinterpret_cast<float*>(smem + L.sx);
  int* info = reinterpret_cast<int*>(smem + L.info);           // [3][R]
  float* red = reinterpret_cast<float*>(smem + L.red);
  const T* x = static_cast<const T*>(a.x) + (size_t)a.row0 * D;
  // every block of the cluster has started before any writes another's
  // shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // --- a. q/k/v over this block's D rows: the first weight steps go out
  // before x is staged
  const int nsteps = ke > kb ? (ke - kb) / FU_KSTEP : 0;
  const int nsw = max(1, (nsteps + FU_WARPS - 1) / FU_WARPS);   // steps a warp, a tile
  const int nT = (NC + FU_BN - 1) / FU_BN, nu = nT * nsw;
  // unit u: tile u / nsw, k step warp + FU_WARPS (u % nsw)
  auto qkv_load = [&](int u, uint4 (&w)[4]) {
    const int j = warp + FU_WARPS * (u % nsw), col = (u / nsw) * FU_BN + 16 * g;
    const bool in = u < nu && j < nsteps && col < NC;
    int ld = 0;
    const float* s_;
    const int8_t* p = in ? qkv_col(a, h, Gd, col, ld, s_) : nullptr;
    const int k0 = kb + FU_KSTEP * j + 4 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = in ? ldg_stream(p + (size_t)(k0 + i) * ld) : make_uint4(0, 0, 0, 0);
  };
  uint4 w[FU_DEPTH][4];
  if constexpr (MMA) {
#pragma unroll
    for (int d = 0; d < FU_DEPTH; ++d) qkv_load(d, w[d]);
  }

  // the cache rows this block attends, and an empty attention table
  if (tid < R) {
    const int m = tid * C + rank, b = a.row0 + m;
    int nv = 0, ev = -1;
    if (m < Bg) {
      nv = a.n_valid ? a.n_valid[b] : a.nv_scalar;
      ev = a.evict ? a.evict[b] : a.ev_scalar;
    }
    nv = max(0, min(nv, a.W));
    info[tid] = nv;
    info[R + tid] = ev;
    info[2 * R + tid] = (nv + FU_BS - 1) / FU_BS;
  }

  // x: this block's slice, 16 bytes a load where the widths allow.  a8:
  // the slice goes to shared memory as float first; each block's row maxima
  // go to every block of the cluster, and after one cluster barrier every
  // block holds the whole rows' maxima (exact in any order) and quantizes
  // its slice with them.
  constexpr int E16 = 16 / (int)sizeof(T);
  float* xraw = reinterpret_cast<float*>(smem + L.part);       // a8: [FU_ROWS][kpb]
  unsigned* rmax = reinterpret_cast<unsigned*>(smem + L.xmax);  // [FU_MAX_CLUSTER + 1][FU_ROWS]
  if constexpr (A8) {
    if (tid < FU_ROWS) rmax[FU_MAX_CLUSTER * FU_ROWS + tid] = 0u;
    __syncthreads();
  }
  auto stage = [&](int i, float v) {            // element i of the [FU_ROWS][kpb] slice
    if constexpr (A8)
      xraw[i] = v;
    else if constexpr (MMA)
      reinterpret_cast<__nv_bfloat16*>(smem + L.xs)[i] = __float2bfloat16_rn(v);  // exact
    else
      reinterpret_cast<float*>(smem + L.xs)[i] = v;
  };
  float mx = 0.f;                               // a8: the thread's row maximum
  int mrow = -1;
  auto row_max = [&](int m, float v) {
    if constexpr (A8) {
      if (m != mrow) {
        if (mrow >= 0) atomicMax(&rmax[FU_MAX_CLUSTER * FU_ROWS + mrow], __float_as_uint(mx));
        mrow = m;
        mx = 0.f;
      }
      mx = fmaxf(mx, fabsf(v));
    }
  };
  if (D % E16 == 0 && kpb % E16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int cpr = kpb / E16;                   // 16-byte pieces of a row's slice
#pragma unroll 4
    for (int c = tid; c < FU_ROWS * cpr; c += FU_THREADS) {
      const int m = c / cpr, d = kb + (c - m * cpr) * E16;
      const uint4 u = m < Bg && d < D
          ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * D + d)) : make_uint4(0, 0, 0, 0);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < E16; ++k) {
        const float v = to_f32(e[k]);
        stage(m * kpb + d - kb + k, v);
        row_max(m, v);
      }
    }
  } else {
    for (int i = tid; i < FU_ROWS * kpb; i += FU_THREADS) {
      const int m = i / kpb, d = kb + i - m * kpb;
      const float v = (m < Bg && d < D) ? to_f32(x[(size_t)m * D + d]) : 0.f;
      stage(i, v);
      row_max(m, v);
    }
  }
  if constexpr (A8) {
    if (mrow >= 0) atomicMax(&rmax[FU_MAX_CLUSTER * FU_ROWS + mrow], __float_as_uint(mx));
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if constexpr (A8) {
    if (tid < C * FU_ROWS) {
      const int dst = tid / FU_ROWS, m = tid % FU_ROWS;
      cluster.map_shared_rank(rmax, dst)[rank * FU_ROWS + m] = rmax[FU_MAX_CLUSTER * FU_ROWS + m];
    }
    cluster.sync();
    if (tid < FU_ROWS) {
      unsigned v = 0u;
      for (int r = 0; r < C; ++r) v = max(v, rmax[r * FU_ROWS + tid]);
      const float amax = __uint_as_float(v);
      sx[tid] = amax > 0.f ? __fmul_rn(amax, a.inv127) : 1.f;
    }
    __syncthreads();
    for (int i = tid; i < FU_ROWS * kpb; i += FU_THREADS)
      reinterpret_cast<int8_t*>(smem + L.xs)[i] = quant8(xraw[i], sx[i / kpb]);
    __syncthreads();
  }

  if constexpr (MMA) {
    AccT* part = reinterpret_cast<AccT*>(smem + L.part);        // [FU_WARPS][FU_TILE]
    AccT tacc[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) tacc[p][r] = 0;
    for (int u0 = 0; u0 < nu; u0 += FU_DEPTH) {
#pragma unroll
      for (int d = 0; d < FU_DEPTH; ++d) {
        const int u = u0 + d;
        if (u < nu) {
          const int j = warp + FU_WARPS * (u % nsw);
          if (j < nsteps) {
            const int kk = g * kpb + FU_KSTEP * j + 4 * t;
            if constexpr (A8) {
              step_s8(tacc, w[d], *reinterpret_cast<const uint32_t*>(
                                      reinterpret_cast<const int8_t*>(smem + L.xs) + kk));
            } else {
              const uint2 xv = *reinterpret_cast<const uint2*>(
                  reinterpret_cast<const __nv_bfloat16*>(smem + L.xs) + kk);
              step_bf16<false>(tacc, w[d], xv, xv);
            }
          }
          qkv_load(u + FU_DEPTH, w[d]);
          if ((u + 1) % nsw == 0) {
            // the tile is summed: add the warps in warp order and send row
            // m's sums to the block that owns it
            const int T_ = u / nsw;
#pragma unroll
            for (int p = 0; p < 8; ++p)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                part[warp * FU_TILE + (4 * p + r) * 32 + lane] = tacc[p][r];
                tacc[p][r] = 0;
              }
            __syncthreads();
            for (int e = tid; e < FU_TILE; e += FU_THREADS) {
              AccT s = part[e];
#pragma unroll
              for (int v = 1; v < FU_WARPS; ++v) s += part[v * FU_TILE + e];
              int m, c;
              mma_tile_element(e, m, c);
              c += T_ * FU_BN;
              if (m < Bg && c < NC) {
                float* dst = cluster.map_shared_rank(recv, m % C);
                if constexpr (A8) dst[((size_t)rank * R + m / C) * NC + c] = __int_as_float(s);
                else dst[((size_t)rank * R + m / C) * NC + c] = s;
              }
            }
            __syncthreads();
          }
        }
      }
    }
  } else {
    // CUDA cores: a thread a column, the block's D rows in order
    for (int c = tid; c < NC; c += FU_THREADS) {
      int ld;
      const float* s_;
      const int8_t* p = qkv_col(a, h, Gd, c, ld, s_);
      AccT s[FU_ROWS];
#pragma unroll
      for (int m = 0; m < FU_ROWS; ++m) s[m] = 0;
#pragma unroll 4
      for (int d = kb; d < ke; ++d) {
        const int wv = __ldg(p + (size_t)d * ld);
#pragma unroll
        for (int m = 0; m < FU_ROWS; ++m) {
          if constexpr (A8)
            s[m] += (int)reinterpret_cast<const int8_t*>(smem + L.xs)[m * kpb + d - kb] * wv;
          else
            s[m] = fmaf(reinterpret_cast<const float*>(smem + L.xs)[m * kpb + d - kb],
                        (float)wv, s[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < FU_ROWS; ++m)
        if (m < Bg) {
          float* dst = cluster.map_shared_rank(recv, m % C);
          if constexpr (A8) dst[((size_t)rank * R + m / C) * NC + c] = __int_as_float(s[m]);
          else dst[((size_t)rank * R + m / C) * NC + c] = s[m];
        }
    }
  }
  cluster.sync();

  // own rows: the C blocks' sums in rank order, scaled; rope; k1/v1 out
  for (int i = 0; i < Rv; ++i) {
    const int m = i * C + rank;
    for (int c = tid; c < NC; c += FU_THREADS) {
      int ld;
      const float* s_;
      qkv_col(a, h, Gd, c, ld, s_);
      float v;
      if constexpr (A8) {
        int s = 0;
        for (int src = 0; src < C; ++src) s += __float_as_int(recv[((size_t)src * R + i) * NC + c]);
        v = __fmul_rn(__fmul_rn((float)s, sx[m]), *s_);
      } else {
        float s = recv[(size_t)i * NC + c];
        for (int src = 1; src < C; ++src) s += recv[((size_t)src * R + i) * NC + c];
        v = __fmul_rn(s, *s_);
      }
      own[(size_t)i * NC + c] = v;
    }
  }
  __syncthreads();
  if (a.use_rope) {
    for (int i = 0; i < Rv; ++i)
      for (int idx = tid; idx < (G + 1) * half; idx += FU_THREADS) {
        float* r = own + (size_t)i * NC + (idx / half) * dh;   // q heads, then k1
        const int j = idx % half;
        const float t1 = r[j], t2 = r[half + j];
        const float c = a.cos[j], s = a.sin[j];
        r[j] = t1 * c - t2 * s;
        r[half + j] = t1 * s + t2 * c;
      }
    __syncthreads();
  }
  for (int i = 0; i < Rv; ++i) {
    const int m = i * C + rank;
    const size_t kvo = ((size_t)(a.row0 + m) * nkv + h) * dh;
    float* r = own + (size_t)i * NC;
    for (int idx = tid; idx < Gd + 2 * dh; idx += FU_THREADS) {
      if (idx < Gd) r[idx] *= a.scale;
      else if (idx < Gd + dh) static_cast<T*>(a.k1)[kvo + idx - Gd] = from_f32<T>(r[idx]);
      else static_cast<T*>(a.v1)[kvo + idx - Gd - dh] = from_f32<T>(r[idx]);
    }
  }
  __syncthreads();                   // the projection's region is now the ring

  // --- b. attention over this block's rows
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  const int tile_elems = FU_BS * dh;
  int iss_i = 0, iss_t = 0, iss_n = 0;    // next tile to copy: own row, tile; tiles copied
  auto fetch = [&]() {
    while (iss_i < Rv && iss_t >= info[2 * R + iss_i]) { ++iss_i; iss_t = 0; }
    if (iss_i < Rv) {
      const int b = a.row0 + iss_i * C + rank, s0 = iss_t * FU_BS;
      const int n = min(FU_BS, info[iss_i] - s0);
      T* kt = ring + (size_t)(iss_n % S) * 2 * tile_elems;
      T* vt = kt + tile_elems;
      if (a.wide_kv) {
        const int P16 = dh * (int)sizeof(T) / 16;
        for (int p = tid; p < n * P16; p += FU_THREADS) {
          const int j = p / P16, c = p - j * P16;
          const long long off = addr(b, s0 + j, h) + c * E16;
          cp_async16(kt + j * dh + c * E16, kc + off);
          cp_async16(vt + j * dh + c * E16, vc + off);
        }
      } else {
        for (int e = tid; e < n * dh; e += FU_THREADS) {
          const int j = e / dh, d = e - j * dh;
          const long long off = addr(b, s0 + j, h) + d;
          kt[e] = kc[off];
          vt[e] = vc[off];
        }
      }
      ++iss_t;
      ++iss_n;
    }
    cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) fetch();

  // Warp w takes slots [SPW w, SPW (w + 1)) of every tile with its own
  // running max, denominator and P.V sums; the warps are merged in warp
  // order at the row's end.
  const int dpl = dh == 32 || dh == 64 || dh == 128 ? dh / 32 : 0;
  float* wacc = acc + (size_t)warp * Gd;
  int used = 0;                           // tiles consumed
  for (int i = 0; i < Rv; ++i) {
    const int m = i * C + rank;
    const int nv = info[i], ev = info[R + i], ntile = info[2 * R + i];
    const float* q = own + (size_t)i * NC;
    const float* k1s = q + Gd;
    const float* v1s = k1s + dh;
    for (int idx = lane; idx < Gd; idx += 32) wacc[idx] = 0.f;
    for (int gg = lane; gg < G; gg += 32) {
      st_m[warp * G + gg] = NEG;
      st_l[warp * G + gg] = 0.f;
    }
    __syncwarp();
    for (int tt = 0; tt < ntile; ++tt, ++used) {
      if (S == 3) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();                    // tile `used` is in; tile used - 1 is free
      fetch();
      const int s0 = tt * FU_BS, j0 = warp * FU_SPW;
      const int nj = min(FU_SPW, nv - s0 - j0);
      if (nj <= 0) continue;
      const T* kw = ring + (size_t)(used % S) * 2 * tile_elems + (size_t)j0 * dh;
      const T* vw = kw + tile_elems;
      float* wm = st_m + warp * G;
      float* wl = st_l + warp * G;
      switch (dpl) {
        case 4: warp_tile<4>(kw, vw, nj, s0 + j0, ev, q, wacc, wm, wl, G, dh, lane); break;
        case 2: warp_tile<2>(kw, vw, nj, s0 + j0, ev, q, wacc, wm, wl, G, dh, lane); break;
        case 1: warp_tile<1>(kw, vw, nj, s0 + j0, ev, q, wacc, wm, wl, G, dh, lane); break;
        default: warp_tile<0>(kw, vw, nj, s0 + j0, ev, q, wacc, wm, wl, G, dh, lane);
      }
    }
    __syncthreads();
    // merge the warps in warp order, then the current token, last
    for (int gg = warp; gg < G; gg += FU_WARPS) {
      float s = 0.f;
      for (int d = lane; d < dh; d += 32) s = fmaf(q[gg * dh + d], k1s[d], s);
      s = warp_sum(s);
      if (lane == 0) {
        float mw = NEG;
        for (int v = 0; v < FU_WARPS; ++v) mw = fmaxf(mw, st_m[v * G + gg]);
        float lw = 0.f;
        for (int v = 0; v < FU_WARPS; ++v) {
          const float e = expf(st_m[v * G + gg] - mw);
          st_w[gg * FU_WARPS + v] = e;
          lw = fmaf(e, st_l[v * G + gg], lw);
        }
        const float m_fin = fmaxf(mw, s);
        const float p = expf(s - m_fin), al = expf(mw - m_fin);
        st_a[gg] = al;
        st_p[gg] = p;
        st_f[gg] = al * lw + p;
      }
    }
    __syncthreads();
    float amax = 0.f;
    for (int idx = tid; idx < Gd; idx += FU_THREADS) {
      const int gg = idx / dh, d = idx - gg * dh;
      float av = 0.f;
#pragma unroll
      for (int v = 0; v < FU_WARPS; ++v) av = fmaf(acc[v * Gd + idx], st_w[gg * FU_WARPS + v], av);
      const float o = (av * st_a[gg] + st_p[gg] * v1s[d]) / fmaxf(st_f[gg], 1e-30f);
      attn[idx] = o;
      amax = fmaxf(amax, fabsf(o));
    }
    // the row's attention, as wo takes it (a8: as int8 of one row of
    // G dh, with its scale), for the cluster's blocks to read
    float sxa = 1.f;
    if constexpr (A8) {
      amax = warp_max(amax);
      if (lane == 0) red[warp] = amax;
      __syncthreads();
      float mx = 0.f;
#pragma unroll
      for (int v = 0; v < FU_WARPS; ++v) mx = fmaxf(mx, red[v]);
      sxa = mx > 0.f ? __fmul_rn(mx, a.inv127) : 1.f;
      if (tid == 0) osx[i] = sxa;
    } else {
      __syncthreads();
    }
    unsigned char* oa = smem + L.oatt;
    for (int e = tid; e < Gd; e += FU_THREADS) {
      const float o = attn[e];
      if constexpr (A8) {
        reinterpret_cast<int8_t*>(oa)[i * Gd + e] = quant8(o, sxa);
      } else if constexpr (MMA) {
        const __nv_bfloat16 hi = __float2bfloat16_rn(o);
        const __nv_bfloat16 lo = __float2bfloat16_rn(o - __bfloat162float(hi));
        reinterpret_cast<__nv_bfloat16*>(oa)[i * Gd + e] = hi;
        reinterpret_cast<__nv_bfloat16*>(oa)[(R + i) * Gd + e] = lo;
      } else {
        reinterpret_cast<float*>(oa)[i * Gd + e] = o;
      }
    }
    __syncthreads();
  }
  // --- c. wo columns [c0, c1) of this head's G dh rows, every row; the
  // first weight steps go out before the cluster barrier
  const int c0 = rank * a.wcols, c1 = min(D, c0 + a.wcols);
  const int8_t* wo_h = a.wo + (size_t)h * Gd * D;
  float* part_out = a.part + (size_t)a.row0 * nkv * D + (size_t)h * D;
  const int nTo = c1 > c0 ? (c1 - c0 + FU_BN - 1) / FU_BN : 0;
  const int ns = Gd / FU_KSTEP;
  const int ntw = warp < nTo ? (nTo - warp + FU_WARPS - 1) / FU_WARPS : 0;
  const int nuo = ntw * ns;
  // unit u: tile warp + FU_WARPS (u / ns), k step u % ns
  auto wo_load = [&](int u, uint4 (&w)[4]) {
    const int col = c0 + (warp + FU_WARPS * (u / ns)) * FU_BN + 16 * g;
    const bool in = u < nuo && col < c1;
    const int k0 = FU_KSTEP * (u % ns) + 4 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = in ? ldg_stream(wo_h + (size_t)(k0 + i) * D + col) : make_uint4(0, 0, 0, 0);
  };
  if constexpr (MMA) {
#pragma unroll
    for (int d = 0; d < FU_DEPTH; ++d) wo_load(d, w[d]);
  }
  cp_async_wait<0>();
  cluster.sync();                    // every row's attention is final
  // every row's attention from the block that owns it, into the first
  // region; then each block arrives at a cluster barrier that it waits on
  // only before it exits, so that none exits while another reads it
  for (int idx = tid; idx < FU_ROWS * Gd; idx += FU_THREADS) {
    const int m = idx / Gd, e = idx - m * Gd;
    unsigned char* dst = smem + L.aall;
    const unsigned char* src = m < Bg ? cluster.map_shared_rank(smem + L.oatt, m % C) : nullptr;
    const int si = (m / C) * Gd + e;
    if constexpr (A8) {
      reinterpret_cast<int8_t*>(dst)[idx] = src ? reinterpret_cast<const int8_t*>(src)[si] : 0;
    } else if constexpr (MMA) {
      const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
      reinterpret_cast<__nv_bfloat16*>(dst)[idx] =
          src ? reinterpret_cast<const __nv_bfloat16*>(src)[si] : z;
      reinterpret_cast<__nv_bfloat16*>(dst)[FU_ROWS * Gd + idx] =
          src ? reinterpret_cast<const __nv_bfloat16*>(src)[R * Gd + si] : z;
    } else {
      reinterpret_cast<float*>(dst)[idx] = src ? reinterpret_cast<const float*>(src)[si] : 0.f;
    }
  }
  if constexpr (A8) {
    if (tid < FU_ROWS) asx[tid] = tid < Bg ? cluster.map_shared_rank(osx, tid % C)[tid / C] : 1.f;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if constexpr (MMA) {
    AccT tacc[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) tacc[p][r] = 0;
    for (int u0 = 0; u0 < nuo; u0 += FU_DEPTH) {
#pragma unroll
      for (int d = 0; d < FU_DEPTH; ++d) {
        const int u = u0 + d;
        if (u < nuo) {
          const int kk = g * Gd + FU_KSTEP * (u % ns) + 4 * t;
          if constexpr (A8) {
            step_s8(tacc, w[d], *reinterpret_cast<const uint32_t*>(
                                    reinterpret_cast<const int8_t*>(smem + L.aall) + kk));
          } else {
            const __nv_bfloat16* ab = reinterpret_cast<const __nv_bfloat16*>(smem + L.aall);
            step_bf16<true>(tacc, w[d], *reinterpret_cast<const uint2*>(ab + kk),
                            *reinterpret_cast<const uint2*>(ab + FU_ROWS * Gd + kk));
          }
          wo_load(u + FU_DEPTH, w[d]);
          if ((u + 1) % ns == 0) {
            // the tile's rows through shared memory, then 512 contiguous
            // bytes a row
            const int cb = c0 + (warp + FU_WARPS * (u / ns)) * FU_BN;
            float* tile = reinterpret_cast<float*>(smem + L.ring) + warp * FU_ROWS * FU_WOS;
#pragma unroll
            for (int p = 0; p < 8; ++p)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int m = 2 * t + (r & 1), cl = 16 * g + 2 * p + (r >> 1), c = cb + cl;
                float v = 0.f;
                if (m < Bg && c < c1) {
                  if constexpr (A8) v = __fmul_rn(__fmul_rn((float)tacc[p][r], asx[m]), a.so[c]);
                  else v = __fmul_rn(tacc[p][r], a.so[c]);
                }
                tile[m * FU_WOS + cl] = v;
                tacc[p][r] = 0;
              }
            __syncwarp();
            for (int m = 0; m < Bg; ++m)
              if (cb + 4 * lane < c1)
                *reinterpret_cast<float4*>(part_out + (size_t)m * nkv * D + cb + 4 * lane) =
                    *reinterpret_cast<const float4*>(tile + m * FU_WOS + 4 * lane);
            __syncwarp();
          }
        }
      }
    }
  } else {
    for (int c = c0 + tid; c < c1; c += FU_THREADS) {
      AccT s[FU_ROWS];
#pragma unroll
      for (int m = 0; m < FU_ROWS; ++m) s[m] = 0;
#pragma unroll 4
      for (int kk = 0; kk < Gd; ++kk) {
        const int wv = __ldg(wo_h + (size_t)kk * D + c);
#pragma unroll
        for (int m = 0; m < FU_ROWS; ++m) {
          if constexpr (A8)
            s[m] += (int)reinterpret_cast<const int8_t*>(smem + L.aall)[m * Gd + kk] * wv;
          else
            s[m] = fmaf(reinterpret_cast<const float*>(smem + L.aall)[m * Gd + kk],
                        (float)wv, s[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < FU_ROWS; ++m)
        if (m < Bg) {
          float v;
          if constexpr (A8) v = __fmul_rn(__fmul_rn((float)s[m], asx[m]), a.so[c]);
          else v = __fmul_rn(s[m], a.so[c]);
          part_out[(size_t)m * nkv * D + c] = v;
        }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

template <typename T, bool A8, bool MMA, typename Addr>
int launch_t(FusedArgs a, void* out, int C, Addr addr, cudaStream_t st) {
  const int G = a.nh / a.nkv;
  // FU_STAGES tiles in flight, or one fewer where shared memory is short
  a.stages = FU_STAGES;
  Layout L = layout(C, G, a.dh, a.kpb, (int)sizeof(T), A8, MMA, a.stages);
  if (L.total > FU_SMEM_MAX) {
    a.stages = 2;
    L = layout(C, G, a.dh, a.kpb, (int)sizeof(T), A8, MMA, a.stages);
  }
  if (L.total > FU_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = fused_decode<T, A8, MMA, Addr>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.nkv, 1);
  cfg.blockDim = dim3(FU_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int r0 = 0; r0 < a.B; r0 += FU_ROWS) {
    a.row0 = r0;
    e = cudaLaunchKernelEx(&cfg, kern, a, addr);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)a.B * a.D;
  sum_heads_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<T*>(out), a.B, a.nkv, a.D);
  return (int)cudaGetLastError();
}

// float32 x at a16 is summed on the CUDA cores (bf16 would round it)
template <typename Addr>
int launch(const FusedArgs& a, void* out, int bf16, int a8, int mma, int C, Addr addr,
           cudaStream_t st) {
  if (C < 1 || C > FU_MAX_CLUSTER || a.kpb < 1 || a.wcols < 1
      || (mma && (a.kpb % FU_KSTEP || a.wcols % 16 || a.dh % 16 || a.D % 16)))
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (a8) return mma ? launch_t<__nv_bfloat16, true, true>(a, out, C, addr, st)
                       : launch_t<__nv_bfloat16, true, false>(a, out, C, addr, st);
    return mma ? launch_t<__nv_bfloat16, false, true>(a, out, C, addr, st)
               : launch_t<__nv_bfloat16, false, false>(a, out, C, addr, st);
  }
  if (a8) return mma ? launch_t<float, true, true>(a, out, C, addr, st)
                     : launch_t<float, true, false>(a, out, C, addr, st);
  return launch_t<float, false, false>(a, out, C, addr, st);
}

}  // namespace

extern "C" {

// x (B, D), out (B, D), k1/v1 (B, nkv, dh): float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous.  wq (D, nh*dh), wk/wv (D, nkv*dh), wo (nh*dh, D)
// int8 and their float32 column scales, contiguous; mma = 1 when the
// weights take 16-byte loads (dh and D multiples of 16, 16-byte aligned
// bases; the tensor cores take bf16 x and a8), else every sum runs on the
// CUDA cores.  k/v (B, W, nkv, dh) in x's type, contiguous; wide_kv = 1
// when their rows take 16-byte copies.  n_valid / evict: (B,) int32 device
// pointers, or null to use the scalar for every row.  cos/sin: (dh/2,)
// float32.  part: (B, nkv, D) float32 scratch.  scale = 1/sqrt(dh); inv127
// = float32(1/127).  cluster, kpb, wcols: the plan (fused_plan): blocks of
// a KV head, D rows and wo columns of a block.
int flash_decode_fused(const void* x, const void* wq, const void* sq,
                       const void* wk, const void* sk, const void* wv,
                       const void* sv, const void* wo, const void* so,
                       const void* k, const void* v, const void* n_valid,
                       int nv_scalar, const void* evict, int ev_scalar,
                       const void* cos, const void* sin, void* out, void* k1,
                       void* v1, void* part, int B, int D, int nh, int nkv,
                       int dh, int W, float scale, float inv127, int use_rope,
                       int a8, int bf16, int mma, int wide_kv, int cluster,
                       int kpb, int wcols, void* stream) {
  const FusedArgs a{x, static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                    static_cast<const int8_t*>(wv), static_cast<const int8_t*>(wo),
                    static_cast<const float*>(sq), static_cast<const float*>(sk),
                    static_cast<const float*>(sv), static_cast<const float*>(so), k, v,
                    static_cast<const int*>(n_valid), static_cast<const int*>(evict),
                    nv_scalar, ev_scalar, static_cast<const float*>(cos),
                    static_cast<const float*>(sin), k1, v1, static_cast<float*>(part),
                    B, D, nh, nkv, dh, W, 0, kpb, wcols, scale, inv127, use_rope, wide_kv,
                    FU_STAGES};
  return launch(a, out, bf16, a8, mma, cluster, SlabAddr{W, nkv, dh},
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
                             int bf16, int mma, int wide_kv, int cluster,
                             int kpb, int wcols, void* stream) {
  const FusedArgs a{x, static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                    static_cast<const int8_t*>(wv), static_cast<const int8_t*>(wo),
                    static_cast<const float*>(sq), static_cast<const float*>(sk),
                    static_cast<const float*>(sv), static_cast<const float*>(so), k, v,
                    static_cast<const int*>(n_valid), static_cast<const int*>(evict),
                    nv_scalar, ev_scalar, static_cast<const float*>(cos),
                    static_cast<const float*>(sin), k1, v1, static_cast<float*>(part),
                    B, D, nh, nkv, dh, n_b * bt, 0, kpb, wcols, scale, inv127, use_rope,
                    wide_kv, FU_STAGES};
  const PagedAddr addr{static_cast<const int*>(table), n_b, bt, page_stride,
                       slot_stride, head_stride};
  return launch(a, out, bf16, a8, mma, cluster, addr, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

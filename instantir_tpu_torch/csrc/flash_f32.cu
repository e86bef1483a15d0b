// Flash attention in fp32 for Hopper (sm_90a), head_dim 64: the forward (K1),
// the forward with lse (K2), dQ (K3) and dK/dV (K4) for fp32 models.
//
// Replaces, for fp32 inputs, the TPU kernels of instantir_tpu/ops/attention.py:
// ::flash_attention (_flash_kernel_resident), ::_flash_forward_lse
// (_flash_fwd_lse_kernel_resident) and the two kernels of ::_flash_backward
// (_flash_bwd_dq_kernel_resident, _flash_bwd_dkv_kernel_resident). The Pallas
// kernels take any float dtype with fp32 accumulation; in fp32 every rounding
// point of the bf16 kernels (flash_fwd.cu, flash_bwd.cu) is the identity, so
// these compute, in fp32 throughout:
//   * forward: q2 = q * scale*log2(e); per 32-key tile s = q2 k^T, running max
//     m and sum l with exp2, acc = acc*alpha + p v; o = acc / l and, for K2,
//     lse[B, H, Sq] = m + log2(l) (log2 domain, as the backward expects);
//   * dQ: p = exp2(q2 k^T - lse), dS = p * (dO v^T - D), dq = scale * sum dS k;
//   * dK/dV: k2 = k * scale*log2(e), p^T = exp2(k2 q^T - lse),
//     dv = sum p^T dO, dk = scale * sum (p^T * (v dO^T - D)) q.
//
// What bounds them on the H100: operations. At head_dim 64 a (q row, key)
// pair costs 256 (K1/K2), 384 (K3) or 512 (K4) flops against a few bytes of
// operands, far above the memory ridge.
//   * The forward is FFMA on the CUDA cores: 132 SMs x 128 lanes x 2
//     operations per clock, ~66.9 TFLOP/s at 1.98 GHz.
//   * The backward runs on the tensor cores in 3xTF32. One TF32 product keeps
//     10 mantissa bits and misses the fp32 tolerance of the plain version
//     (relative L2 1e-5). The split product keeps about 21:
//       hi = tf32(x), lo = tf32(x - hi),  a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
//     three TF32 products (495 TFLOP/s dense), an effective 165 TFLOP/s, 2.5x
//     the FFMA rate. PyTorch's fp32 memory-efficient attention takes the same
//     route (CUTLASS's OpMultiplyAddFastF32 on mma 16x8x8).
//
// Design of the forward: a simple tiled SIMT kernel.
//   * One CTA of 128 threads owns 64 q rows of one (batch, head). Two
//     neighbouring lanes share a row, each holding 32 of its 64 columns in
//     registers as 8 float4 chunks (chunk c of lane `half` covers columns
//     8c + 4*half .. +3, so a pair reads two adjacent 16-byte words of a
//     shared-memory row: one broadcast, no bank conflict); a dot product is
//     each lane's 32 FFMA plus one __shfl_xor_sync.
//   * K and V stream through static shared memory in tiles of 32 rows, loaded
//     by all threads as float4 between two __syncthreads; rows past the
//     sequence are zero-filled and get score -inf.
//
// Design of the backward (dQ and dK/dV, one deterministic kernel each).
//   * Products: mma.sync m16n8k8 .tf32 with fp32 accumulators, each as three
//     mma's into one accumulator, small terms first (lo*hi, hi*lo, hi*hi), as
//     CUTLASS's FastF32 orders them. Splits round to nearest with ties away,
//     as cvt.rna.tf32.f32 does, in four integer and float instructions.
//   * One CTA of 4 warps owns 64 rows (q rows for dQ, keys for dK/dV), 16 a
//     warp, for the whole sweep over the other side. Its own two operands
//     (q2 and dO; k2 and V) are staged once into shared memory, scaled in
//     fp32 on the way; the streamed ones (K and V; Q, dO and their lse and D
//     rows) come in tiles of 32 rows by 16-byte cp.async copies into a
//     2-stage ring, the next tile's copy under the current tile's products.
//     64 KB of shared memory: three CTAs per SM for dQ (153 registers), two
//     for dK/dV (223 registers: its two 16 x 64 accumulators).
//   * Shared memory holds fp32 and each warp splits what it reads. Split
//     planes, each streamed element split once per CTA into a hi and a lo
//     tile, were measured on the H100 and gained nothing: dK/dV took the same
//     time and dQ lost its third CTA per SM (96 KB) and 6%. The split's ALU
//     work is not what bounds these kernels; the mma.sync rate is (PERF.md).
//   * Score products (S = q2 K^T, dP = dO V^T; S^T = k2 Q^T, dP^T = V dO^T),
//     both in one loop (eight independent accumulators): the reduction index
//     k of chunk c is mapped to head column 16*(k % 4) + 2c + k / 4, so lane
//     (g, t) finds all its A and B values of a row in the four 16-byte chunks
//     4t .. 4t + 3: one LDS.128 feeds two k-chunks.
//   * Accumulating products (dQ += dS K; dV += P^T dO, dK += dS^T Q): P and
//     dS leave the mma in the accumulator layout, where lane (g, t) holds
//     columns 2t and 2t + 1 of each 8-column tile; the A fragment wants
//     columns t and t + 4. No shuffle: the reduction index is permuted
//     instead (k = t is key or q row 2t of the chunk, k = t + 4 is 2t + 1),
//     and the B operand is read from the same two rows. Its output column n of
//     8-column tile j is head column 8n + j, so a lane's B values of a row are
//     two 16-byte chunks and its outputs 16 consecutive columns of a row.
//   * The tensor cores' fp32 accumulation truncates, a bias that grows with
//     the number of sums: each tile's accumulating product starts from zero
//     and is added to the running dQ / dK / dV on the CUDA cores.
//   * Shared-memory layout: rows of 256 bytes; 16-byte chunk c of row r sits
//     at chunk c ^ s(r, c), s mixing r's bits 0-2 and c's bit 3, so both read
//     patterns above and the copies are free of bank conflicts.
//   * Ragged tails as before: keys at or past skv are zero-filled and their
//     dS is 0 (dQ); q rows at or past sq are zero-filled with zero lse and D,
//     and their P and dS are set to 0 (dK/dV); rows past the end of a ragged
//     owned block compute on a copy of the last row and store nothing.
//   * exp2f/log2f and the division acc / l are the accurate library forms, not
//     ex2.approx: the fp32 tolerance leaves no room for them.
//
// Layout: q/o/dO [B, Sq, H, 64], k/v/dk/dv [B, Skv, H, 64], all fp32,
// contiguous and 16-byte aligned; lse and D fp32 [B, H, Sq].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;               // head_dim
constexpr int kRows = 64;            // rows a CTA owns
constexpr int kThreads = 2 * kRows;  // two lanes per row
constexpr int kTile = 32;            // rows of a shared-memory tile
constexpr int kVec = kD / 4;         // float4 per row
constexpr int kChunks = kVec / 2;    // float4 per lane

struct Row {
  float4 c[kChunks];
};

__device__ __forceinline__ void load_row(Row& r, const float* row, int half, float mul) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 x = p[2 * c + half];
    r.c[c] = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

__device__ __forceinline__ void zero_row(Row& r) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) r.c[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The full 64-wide dot product of a register row with shared-memory row `t`:
// this lane's 32 products, then the pair's sum through one shuffle.
__device__ __forceinline__ float pair_dot(const Row& r, const float4 (*tile)[kVec], int t, int half) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = tile[t][2 * c + half];
    s = fmaf(r.c[c].x, x.x, s);
    s = fmaf(r.c[c].y, x.y, s);
    s = fmaf(r.c[c].z, x.z, s);
    s = fmaf(r.c[c].w, x.w, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// r += a * (shared-memory row t), on this lane's columns.
__device__ __forceinline__ void axpy(Row& r, float a, const float4 (*tile)[kVec], int t, int half) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = tile[t][2 * c + half];
    r.c[c].x = fmaf(a, x.x, r.c[c].x);
    r.c[c].y = fmaf(a, x.y, r.c[c].y);
    r.c[c].z = fmaf(a, x.z, r.c[c].z);
    r.c[c].w = fmaf(a, x.w, r.c[c].w);
  }
}

// Rows [r0, r0 + kTile) of a [S, H, 64] operand at `base` (its (b, h) row 0)
// into `tile`, zeros past `s_len`.
__device__ __forceinline__ void load_tile(float4 (*tile)[kVec], const float* base, int r0, int s_len,
                                          long long stride) {
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int t = i / kVec, v = i % kVec;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + t < s_len) x = reinterpret_cast<const float4*>(base + (long long)(r0 + t) * stride)[v];
    tile[t][v] = x;
  }
}

template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const float* __restrict__ q,
                                                                  const float* __restrict__ k,
                                                                  const float* __restrict__ v, float* __restrict__ o,
                                                                  float* __restrict__ lse, int heads, int sq, int skv,
                                                                  float qscale) {
  __shared__ float4 ks[kTile][kVec];
  __shared__ float4 vs[kTile][kVec];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 1);
  const long long stride = (long long)heads * kD;
  const float* kb = k + ((long long)b * skv * heads + h) * kD;
  const float* vb = v + ((long long)b * skv * heads + h) * kD;
  const long long q_off = ((long long)b * sq * heads + h) * kD;

  Row q2, acc;
  load_row(q2, q + q_off + (long long)min(row, sq - 1) * stride, half, qscale);
  zero_row(acc);
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < skv; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile(ks, kb, j0, skv, stride);
    load_tile(vs, vb, j0, skv, stride);
    __syncthreads();
    const int n = min(kTile, skv - j0);
    float s[kTile];
    float m_new = m;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float x = pair_dot(q2, ks, t, half);
      s[t] = t < n ? x : -INFINITY;
      m_new = fmaxf(m_new, s[t]);
    }
    const float alpha = exp2f(m - m_new);  // 0 on the first tile (m = -inf, m_new finite)
    float p_sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      s[t] = exp2f(s[t] - m_new);
      p_sum += s[t];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc.c[c].x *= alpha;
      acc.c[c].y *= alpha;
      acc.c[c].z *= alpha;
      acc.c[c].w *= alpha;
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) axpy(acc, s[t], vs, t, half);
    m = m_new;
  }
  if (row >= sq) return;
  float4* out = reinterpret_cast<float4*>(o + q_off + (long long)row * stride);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    out[2 * c + half] = make_float4(acc.c[c].x / l, acc.c[c].y / l, acc.c[c].z / l, acc.c[c].w / l);
  if (kWriteLse && half == 0) lse[(long long)bh * sq + row] = m + log2f(l);
}

// ---------------------------------------------------------------------------
// The backward: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 64;                     // rows a CTA owns, 16 a warp
constexpr int kBwdThreads = 128;                 // 4 warps
constexpr int kBwdTile = 32;                     // rows of a streamed tile
constexpr int kOwnFloats = kBwdRows * kD;        // an owned 64 x 64 fp32 tile, 16 KB
constexpr int kTileFloats = kBwdTile * kD;       // a streamed 32 x 64 fp32 tile, 8 KB
constexpr int kTileBytes = kTileFloats * 4;
constexpr int kRowsFloats = 2 * kBwdTile;        // lse and D of one q tile (dK/dV)
constexpr int kBwdStages = 2;
constexpr int kDqStageFloats = 2 * kTileFloats;  // K, V
constexpr int kDkvStageFloats = 2 * kTileFloats + kRowsFloats;  // Q, dO, lse, D
constexpr int kDqSmemBytes = (2 * kOwnFloats + kBwdStages * kDqStageFloats) * 4;    // 65,536
constexpr int kDkvSmemBytes = (2 * kOwnFloats + kBwdStages * kDkvStageFloats) * 4;  // 66,048

// Float offset of 16-byte chunk `chunk` (0..15) of row `row` in a swizzled tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  const int s = (((row >> 1) ^ (chunk >> 3)) & 1) | ((row & 1) << 1) | (row & 4);
  return row * kD + ((chunk ^ s) << 2);
}

__device__ __forceinline__ float4 lds4(const float* tile, int row, int chunk) {
  return *reinterpret_cast<const float4*>(tile + swz(row, chunk));
}

// A (16x8) and B (8x8) fragments of one m16n8k8 product, each split in two.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away
// (cvt.rna.tf32.f32) by integer arithmetic on finite values: add half a tf32
// ulp to the magnitude bits and drop the low 13. lo keeps its low bits, which
// the mma ignores; hi needs them cleared, since x - hi is taken from it.
// Four instructions; cvt.rna compiles to seven (an isfinite test and select each).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// a0 = (row g, k t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// b0 = (k t, column g), b1 = (k t + 4, g)
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Rows r0 .. r0 + 63 of a [S, H, 64] operand (`base` is its (b, h) row 0), a
// row at or past s_len replaced by row s_len - 1, times `mul`, into a
// swizzled tile.
__device__ __forceinline__ void stage_own(float* tile, const float* base, int r0, int s_len, long long stride,
                                          float mul, int tid) {
  for (int i = tid; i < kBwdRows * 16; i += kBwdThreads) {
    const int r = i >> 4, c = i & 15;
    float4 x = reinterpret_cast<const float4*>(base + (long long)min(r0 + r, s_len - 1) * stride)[c];
    x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    *reinterpret_cast<float4*>(tile + swz(r, c)) = x;
  }
}

// Start the copies of rows r0 .. r0 + 63 of a [S, H, 64] operand into the
// swizzled tile at shared address `dst`; rows at or past s_len are zero-filled.
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* base, int r0, int s_len, long long stride,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < kBwdTile * 16 / kBwdThreads; ++i) {
    const int idx = tid + i * kBwdThreads;
    const int r = idx >> 4, c = idx & 15;
    const bool ok = r0 + r < s_len;
    cp_async_16(dst + swz(r, c) * 4, base + (long long)(ok ? r0 + r : 0) * stride + c * 4, ok ? 16 : 0);
  }
}

// The two score products of a streamed tile (32 columns: four 8-column
// tiles), over the head dimension:
//   s[n] = own_s[rows ra, ra + 8] . tile_s[8n + g]^T, and dp[n] likewise from
// own_p and tile_p. Both run in one loop: eight independent accumulators,
// three mma's deep per k-chunk, keep the tensor pipe fed.
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], const float* own_s, const float* tile_s,
                                       const float* own_p, const float* tile_p, int ra, int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll 1
  for (int c2 = 0; c2 < 4; ++c2) {  // head columns 16t + 4*c2 .. + 3: k-chunks 2*c2 and 2*c2 + 1
    const int chunk = 4 * t + c2;
    const float4 xa = lds4(own_s, ra, chunk), xb = lds4(own_s, ra + 8, chunk);
    const float4 ya = lds4(own_p, ra, chunk), yb = lds4(own_p, ra + 8, chunk);
    float4 zs[4], zp[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      zs[n] = lds4(tile_s, 8 * n + g, chunk);
      zp[n] = lds4(tile_p, 8 * n + g, chunk);
    }
    const FragA as0 = split_a(xa.x, xb.x, xa.y, xb.y), as1 = split_a(xa.z, xb.z, xa.w, xb.w);
    const FragA ap0 = split_a(ya.x, yb.x, ya.y, yb.y), ap1 = split_a(ya.z, yb.z, ya.w, yb.w);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mma3(s[n], as0, split_b(zs[n].x, zs[n].y));
      mma3(dp[n], ap0, split_b(zp[n].x, zp[n].y));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mma3(s[n], as1, split_b(zs[n].z, zs[n].w));
      mma3(dp[n], ap1, split_b(zp[n].z, zp[n].w));
    }
  }
}

// The eight B values of row `row` that lane g reads for an accumulating
// product: head columns 8g .. 8g + 7 (output column g of 8-column tile j is
// head column 8g + j).
__device__ __forceinline__ void row8(float (&v)[8], const float* tile, int row, int g) {
  const float4 x = lds4(tile, row, 2 * g);
  const float4 y = lds4(tile, row, 2 * g + 1);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// part (+)= p . tile over the 8 rows 8*kc .. 8*kc + 7 of the tile, p given as
// the accumulator of a score product (its 8-column tile kc).
__device__ __forceinline__ void accumulate_chunk(float (&part)[8][4], const float (&p)[4], const float* tile, int kc,
                                                 int g, int t) {
  const FragA a = split_a(p[0], p[2], p[1], p[3]);  // k = t: row 2t of the chunk, k = t + 4: row 2t + 1
  float r0[8], r1[8];
  row8(r0, tile, 8 * kc + 2 * t, g);
  row8(r1, tile, 8 * kc + 2 * t + 1, g);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma3(part[j], a, split_b(r0[j], r1[j]));
}

// acc += p . tile over the 32 rows of a streamed tile. The tensor cores'
// fp32 accumulation truncates, a bias that grows with the number of sums it
// takes (past the fp32 tolerance at S = 2048 when dQ summed all its keys in
// the mma): each tile's product starts from zero and is added to `acc` on
// the CUDA cores, rounded to nearest.
__device__ __forceinline__ void accumulate(float (&acc)[8][4], const float (&p)[4][4], const float* tile, int g,
                                           int t) {
  float part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n) accumulate_chunk(part, p[n], tile, n, g, t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
}

// Store the 16 head columns 16t .. 16t + 15 of a row of an accumulating
// product (acc[j][lo_hi * 2] is column 16t + j, acc[j][lo_hi * 2 + 1] column
// 16t + 8 + j), times `mul`.
__device__ __forceinline__ void store_row16(float* row, const float (&acc)[8][4], int lo_hi, int t, float mul) {
  float4* out = reinterpret_cast<float4*>(row + 16 * t);
  const int e = 2 * lo_hi;
  out[0] = make_float4(acc[0][e] * mul, acc[1][e] * mul, acc[2][e] * mul, acc[3][e] * mul);
  out[1] = make_float4(acc[4][e] * mul, acc[5][e] * mul, acc[6][e] * mul, acc[7][e] * mul);
  out[2] = make_float4(acc[0][e + 1] * mul, acc[1][e + 1] * mul, acc[2][e + 1] * mul, acc[3][e + 1] * mul);
  out[3] = make_float4(acc[4][e + 1] * mul, acc[5][e + 1] * mul, acc[6][e + 1] * mul, acc[7][e + 1] * mul);
}

__global__ void __launch_bounds__(kBwdThreads, 3)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ d_o, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int heads, int sq, int skv,
                        int n_qtiles, float qscale, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q2s = smem;
  float* dos = smem + kOwnFloats;
  float* ring = smem + 2 * kOwnFloats;  // stage s: K, then V
  const uint32_t ring_addr = smem_u32(ring);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles, q0 = (blockIdx.x % n_qtiles) * kBwdRows;
  const int b = bh / heads, h = bh % heads;
  const long long stride = (long long)heads * kD;
  const float* qb = q + ((long long)b * sq * heads + h) * kD;
  const float* dob = d_o + ((long long)b * sq * heads + h) * kD;
  const float* kb = k + ((long long)b * skv * heads + h) * kD;
  const float* vb = v + ((long long)b * skv * heads + h) * kD;
  const int n_tiles = (skv + kBwdTile - 1) / kBwdTile;

  auto load_tile = [&](int j) {
    const uint32_t stage = ring_addr + (j % kBwdStages) * kDqStageFloats * 4;
    copy_tile(stage, kb, j * kBwdTile, skv, stride, tid);
    copy_tile(stage + kTileBytes, vb, j * kBwdTile, skv, stride, tid);
  };
  load_tile(0);
  cp_async_commit();
  stage_own(q2s, qb, q0, sq, stride, qscale, tid);
  stage_own(dos, dob, q0, sq, stride, 1.f, tid);

  const int ra = warp * 16 + g;  // this lane's rows of the CTA's 64: ra and ra + 8
  const int row_a = min(q0 + ra, sq - 1), row_b = min(q0 + ra + 8, sq - 1);
  const float lse_a = lse[(long long)bh * sq + row_a], lse_b = lse[(long long)bh * sq + row_b];
  const float d_a = delta[(long long)bh * sq + row_a], d_b = delta[(long long)bh * sq + row_b];

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);  // into the stage every warp left at the end of turn j - 1
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();     // ... everyone's; and, on turn 0, the staged q2 and dO
    const float* kt = ring + (j % kBwdStages) * kDqStageFloats;
    const float* vt = kt + kTileFloats;
    float s[4][4], dp[4][4];
    scores(s, dp, q2s, kt, dos, vt, ra, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = j * kBwdTile + 8 * n + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool lower = i & 2;  // rows ra + 8
        const float p = exp2f(s[n][i] - (lower ? lse_b : lse_a));
        s[n][i] = key + (i & 1) < skv ? p * (dp[n][i] - (lower ? d_b : d_a)) : 0.f;
      }
    }
    accumulate(acc, s, kt, g, t);
    __syncthreads();  // every warp is done with stage j before turn j + 1 refills it
  }

  float* out = dq + ((long long)b * sq * heads + h) * kD;
  if (q0 + ra < sq) store_row16(out + (long long)(q0 + ra) * stride, acc, 0, t, scale);
  if (q0 + ra + 8 < sq) store_row16(out + (long long)(q0 + ra + 8) * stride, acc, 1, t, scale);
}

__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ d_o, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int sq, int skv, int n_ktiles, float qscale, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k2s = smem;
  float* vs = smem + kOwnFloats;
  float* ring = smem + 2 * kOwnFloats;  // stage s: Q, dO, then lse and D of its rows
  const uint32_t ring_addr = smem_u32(ring);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_ktiles, k0 = (blockIdx.x % n_ktiles) * kBwdRows;
  const int b = bh / heads, h = bh % heads;
  const long long stride = (long long)heads * kD;
  const float* qb = q + ((long long)b * sq * heads + h) * kD;
  const float* dob = d_o + ((long long)b * sq * heads + h) * kD;
  const float* kb = k + ((long long)b * skv * heads + h) * kD;
  const float* vb = v + ((long long)b * skv * heads + h) * kD;
  const float* lb = lse + (long long)bh * sq;
  const float* db = delta + (long long)bh * sq;
  const int n_tiles = (sq + kBwdTile - 1) / kBwdTile;

  auto load_tile = [&](int i) {
    const uint32_t stage = ring_addr + (i % kBwdStages) * kDkvStageFloats * 4;
    copy_tile(stage, qb, i * kBwdTile, sq, stride, tid);
    copy_tile(stage + kTileBytes, dob, i * kBwdTile, sq, stride, tid);
    // lse (threads 0..31) and D (32..63) of the tile's rows, zero past sq; 4-byte copies, as lse + bh*sq is
    // only 4-byte aligned when sq % 4 != 0
    if (tid < kRowsFloats) {
      const int row = i * kBwdTile + (tid & (kBwdTile - 1));
      const bool ok = row < sq;
      cp_async_4(stage + 2 * kTileBytes + tid * 4, (tid < kBwdTile ? lb : db) + (ok ? row : 0), ok ? 4 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();
  stage_own(k2s, kb, k0, skv, stride, qscale, tid);
  stage_own(vs, vb, k0, skv, stride, 1.f, tid);

  const int ra = warp * 16 + g;  // this lane's keys of the CTA's 64: ra and ra + 8
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt = ring + (it % kBwdStages) * kDkvStageFloats;
    const float* dot = qt + kTileFloats;
    const float* lse_s = qt + 2 * kTileFloats;
    const float* d_s = lse_s + kBwdTile;
    float st[4][4], dpt[4][4];  // S^T and dP^T of the tile's 32 q columns, then P^T and dS^T
    scores(st, dpt, k2s, qt, vs, dot, ra, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool odd = i & 1;
        const float p = it * kBwdTile + col + odd < sq ? exp2f(st[n][i] - (odd ? l2.y : l2.x)) : 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - (odd ? dd.y : dd.x));
      }
    }
    accumulate(dv_acc, st, dot, g, t);
    accumulate(dk_acc, dpt, qt, g, t);
    __syncthreads();
  }

  const long long kv_off = ((long long)b * skv * heads + h) * kD;
  if (k0 + ra < skv) {
    store_row16(dk + kv_off + (long long)(k0 + ra) * stride, dk_acc, 0, t, scale);
    store_row16(dv + kv_off + (long long)(k0 + ra) * stride, dv_acc, 0, t, 1.f);
  }
  if (k0 + ra + 8 < skv) {
    store_row16(dk + kv_off + (long long)(k0 + ra + 8) * stride, dk_acc, 1, t, scale);
    store_row16(dv + kv_off + (long long)(k0 + ra + 8) * stride, dv_acc, 1, t, 1.f);
  }
}

dim3 grid_of(int batch, int heads, int rows) { return dim3((rows + kRows - 1) / kRows, batch * heads); }

}  // namespace

// Each entry point launches on `stream` and returns the launch's cudaError_t.

extern "C" int instantir_flash_fwd_f32_d64(const void* q, const void* k, const void* v, void* o, int batch,
                                           int heads, int sq, int skv, float qscale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  flash_fwd_f32_kernel<false><<<grid_of(batch, heads, sq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), nullptr, heads, sq, skv, qscale);
  return (int)cudaGetLastError();
}

// The training forward: also writes lse[B, H, Sq] (fp32, log2 domain).
extern "C" int instantir_flash_fwd_lse_f32_d64(const void* q, const void* k, const void* v, void* o, void* lse,
                                               int batch, int heads, int sq, int skv, float qscale, void* stream) {
  if (lse == nullptr || bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  flash_fwd_f32_kernel<true><<<grid_of(batch, heads, sq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), heads, sq, skv, qscale);
  return (int)cudaGetLastError();
}

extern "C" int instantir_flash_bwd_dq_f32_d64(const void* q, const void* k, const void* v, const void* d_o,
                                              const void* lse, const void* delta, void* dq, int batch, int heads,
                                              int sq, int skv, float qscale, float scale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel, kDqSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kBwdRows - 1) / kBwdRows;
  flash_bwd_dq_f32_kernel<<<(unsigned)(n_qtiles * batch * heads), kBwdThreads, kDqSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), heads, sq, skv, n_qtiles, qscale, scale);
  return (int)cudaGetLastError();
}

extern "C" int instantir_flash_bwd_dkv_f32_d64(const void* q, const void* k, const void* v, const void* d_o,
                                               const void* lse, const void* delta, void* dk, void* dv, int batch,
                                               int heads, int sq, int skv, float qscale, float scale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel, kDkvSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (skv + kBwdRows - 1) / kBwdRows;
  flash_bwd_dkv_f32_kernel<<<(unsigned)(n_ktiles * batch * heads), kBwdThreads, kDkvSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, skv, n_ktiles, qscale, scale);
  return (int)cudaGetLastError();
}

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
// operands, far above the memory ridge. All four run on the tensor cores in
// 3xTF32. One TF32 product keeps 10 mantissa bits and misses the fp32
// tolerance of the plain version (relative L2 1e-5). The split product keeps
// about 21:
//   hi = tf32(x), lo = tf32(x - hi),  a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// three TF32 products (495 TFLOP/s dense), an effective 165 TFLOP/s, 2.5x the
// FFMA rate of the CUDA cores. PyTorch's fp32 memory-efficient attention takes
// the same route (CUTLASS's OpMultiplyAddFastF32 on mma 16x8x8). Splits round
// to nearest with ties away, as cvt.rna.tf32.f32 does, in four integer and
// float instructions; each product is three calls into one accumulator, small
// terms first (lo*hi, hi*lo, hi*hi), as CUTLASS's FastF32 orders them. The
// tensor cores' fp32 accumulation truncates, a bias that grows with the
// number of sums: every streamed tile's accumulating product (P v; dS k,
// P^T dO, dS^T q) starts from zero and is added to the running sum on the
// CUDA cores. exp2f/log2f and the division acc / l are the accurate library
// forms, not ex2.approx: the fp32 tolerance leaves no room for them.
//
// Design of the forward (wgmma in tf32).
//   * One CTA of two consumer warpgroups (256 threads) owns 128 q rows of one
//     (batch, head), 64 a warpgroup, for the whole sweep over the keys in
//     tiles of 32; both warpgroups read the same K/V tiles.
//   * Products: S = q2 K^T is 8 steps over the head dimension of three
//     wgmma m64n32k8 each, A (q2 hi / lo) from registers (split once, when
//     the CTA starts), B (K hi / lo) from shared memory; O_tile = P V is 4
//     steps over the tile's keys of three wgmma m64n64k8 each, A (P hi / lo)
//     from registers, B (V^T hi / lo) from shared memory. tf32 wgmma takes
//     K-major operands only: K [key][d] is K-major for S as it is; V is
//     stored transposed, V^T [d][key]. q2 in registers rather than shared
//     memory measured 17-20% faster on the H100 (S reads no A operand from
//     shared memory; PERF.md §6).
//   * wgmma reads B from shared memory, so K and V are split once per CTA
//     into hi and lo planes there, not per warp as the backward's mma.sync
//     does. Each tile comes from global memory into registers (key = lane, 8
//     head columns a warp: 32-byte pieces) a tile ahead, and all 256 threads
//     split it into the four planes of its ring stage while the tensor cores
//     run the current tile's products; a warp's V^T stores write one 128-byte
//     row, 32 words, no bank conflict. Two warpgroups halve each thread's
//     share of that work: one warpgroup per CTA (two CTAs per SM) measured
//     0.400 ms at B=2, S=2048, H=10 against 0.284.
//   * The layout of P: the fp32 accumulator gives lane (g, t) keys 2t and
//     2t + 1 of each 8-key step, the tf32 A fragment wants k = t and t + 4.
//     The reduction index is permuted instead of shuffling: k = t is key 2t,
//     k = t + 4 is key 2t + 1, and keys are written to the V^T planes in that
//     order (position of key r: (r & ~7) | (r & 1) << 2 | (r >> 1) & 3).
//   * Each turn: barrier (tile j's planes are in; every warp is done with
//     tile j - 2) -> S of tile j and P V of tile j - 1 (into a zeroed
//     accumulator) -> under them, split and store tile j + 1, then start the
//     loads of tile j + 2 -> wait for S -> softmax (max over the 4 lanes of a
//     row, exp2f) while P V runs -> wait -> acc = (acc + P V) * alpha -> P
//     split into A fragments. P V of tile j - 1 still reads its stage while
//     tile j + 1 is written: the ring has three stages. Without this overlap
//     (P V after the softmax, two stages) the kernel measured 5-14% slower.
//   * Resources: 237 registers (ptxas), so one CTA of 256 threads per SM
//     (60,672 of 65,536 registers): two warpgroups per SM. Shared memory:
//     planes of 128-byte rows in the 128-byte swizzle, a stage holding K hi,
//     K lo (32 keys x 64, two column blocks of 32: 8 KB each) and V^T hi,
//     V^T lo (64 x 32 keys: 8 KB each), 32 KB; three stages + 1 KB alignment
//     slack = 99,328 bytes of the 232,448 an SM gives its CTAs.
//   * Ragged tails: keys at or past skv are zero-filled and get score -inf;
//     q rows at or past sq are zero and store nothing.
//
// Design of the backward (dQ and dK/dV, one deterministic kernel each).
//   * Products: mma.sync m16n8k8 .tf32 with fp32 accumulators, split as above.
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
//     dS leave the mma in the accumulator layout; the reduction index is
//     permuted as in the forward (k = t is key or q row 2t of the chunk, k =
//     t + 4 is 2t + 1), and the B operand is read from the same two rows. Its
//     output column n of 8-column tile j is head column 8n + j, so a lane's B
//     values of a row are two 16-byte chunks and its outputs 16 consecutive
//     columns of a row.
//   * Shared-memory layout: rows of 256 bytes; 16-byte chunk c of row r sits
//     at chunk c ^ s(r, c), s mixing r's bits 0-2 and c's bit 3, so both read
//     patterns above and the copies are free of bank conflicts.
//   * Ragged tails as before: keys at or past skv are zero-filled and their
//     dS is 0 (dQ); q rows at or past sq are zero-filled with zero lse and D,
//     and their P and dS are set to 0 (dK/dV); rows past the end of a ragged
//     owned block compute on a copy of the last row and store nothing.
//
// Layout: q/o/dO [B, Sq, H, 64], k/v/dk/dv [B, Skv, H, 64], all fp32,
// contiguous and 16-byte aligned; lse and D fp32 [B, H, Sq].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;  // head_dim

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

// ---------------------------------------------------------------------------
// The forward: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

constexpr int kFwdWarpgroups = 2;                     // consumer warpgroups a CTA, 64 q rows each
constexpr int kFwdRows = 64 * kFwdWarpgroups;         // q rows a CTA owns
constexpr int kFwdThreads = 128 * kFwdWarpgroups;
constexpr int kFwdKeys = 32;                          // keys of a streamed tile
constexpr int kKPlane = kFwdKeys * kD * 4;            // K hi or lo: 8,192
constexpr int kVPlane = kD * kFwdKeys * 4;            // V^T hi or lo: 8,192
constexpr int kFwdStage = 2 * kKPlane + 2 * kVPlane;  // 32,768
constexpr int kFwdStages = 3;                         // ring stages
constexpr int kFwdSmemBytes = kFwdStages * kFwdStage + 1024;  // + alignment slack: 99,328

// Byte offset of column `col` (a head column, or a key's position in V^T) of
// row `row` in a plane of `rows` rows: column blocks of 32 fp32, 128-byte
// rows, 16-byte chunk c of row r at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t plane_off(int row, int col, int rows) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col >> 2) & 7) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// The split of four consecutive values into the hi and lo planes.
__device__ __forceinline__ void store_split4(uint8_t* hi_plane, uint8_t* lo_plane, uint32_t off, float4 x) {
  uint4 hi, lo;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(hi_plane + off) = hi;
  *reinterpret_cast<uint4*>(lo_plane + off) = lo;
}

// d (+)= a b over 8 head columns in 3xTF32, small terms first: S = q2 K^T.
__device__ __forceinline__ void wgmma3_rs(float (&d)[16], const FragA& a, uint64_t b_hi, uint64_t b_lo,
                                          int scale_d) {
  wgmma_m64n32k8_tf32_rs(d, a.lo, b_hi, scale_d);
  wgmma_m64n32k8_tf32_rs(d, a.hi, b_lo, 1);
  wgmma_m64n32k8_tf32_rs(d, a.hi, b_hi, 1);
}

// d (+)= a b over 8 keys in 3xTF32, small terms first: O_tile = P V.
__device__ __forceinline__ void wgmma3_rs(float (&d)[32], const FragA& a, uint64_t b_hi, uint64_t b_lo,
                                          int scale_d) {
  wgmma_m64n64k8_tf32_rs(d, a.lo, b_hi, scale_d);
  wgmma_m64n64k8_tf32_rs(d, a.hi, b_lo, 1);
  wgmma_m64n64k8_tf32_rs(d, a.hi, b_hi, 1);
}

template <bool kWriteLse>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int heads, int sq, int skv, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw_addr);  // stages of [K hi][K lo][V^T hi][V^T lo]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, q0 = blockIdx.x * kFwdRows;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const long long stride = (long long)heads * kD;
  const float* qb = q + ((long long)b * sq * heads + h) * kD;
  const float* kb = k + ((long long)b * skv * heads + h) * kD;
  const float* vb = v + ((long long)b * skv * heads + h) * kD;
  const int n_tiles = (skv + kFwdKeys - 1) / kFwdKeys;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // q2 = q * qscale in fp32, split, as the A fragments of S's 8 steps: step ks holds head columns 8 ks + t
  // and 8 ks + t + 4 of this thread's two rows. Rows past sq are zero.
  FragA qf[8];
  {
    const float* p0 = qb + (long long)min(row0, sq - 1) * stride;
    const float* p1 = qb + (long long)min(row0 + 8, sq - 1) * stride;
    const float s0 = row0 < sq ? qscale : 0.f, s1 = row0 + 8 < sq ? qscale : 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      qf[ks] = split_a(p0[8 * ks + t] * s0, p1[8 * ks + t] * s1, p0[8 * ks + t + 4] * s0, p1[8 * ks + t + 4] * s1);
  }

  // This thread's share of a K/V tile: key `lane`, head columns 8 * warp .. + 7, zero past skv.
  constexpr int kChunks = kD / 4 / (kFwdThreads / 32);  // float4 of a K (and a V) row a warp takes
  float4 kr[kChunks], vr[kChunks];
  auto load_tile = [&](int tile) {
    const int key = tile * kFwdKeys + lane;
    const bool ok = key < skv;
    const float4* ks = reinterpret_cast<const float4*>(kb + (long long)(ok ? key : 0) * stride) + kChunks * warp;
    const float4* vs = reinterpret_cast<const float4*>(vb + (long long)(ok ? key : 0) * stride) + kChunks * warp;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      kr[c] = ok ? ks[c] : zero4;
      vr[c] = ok ? vs[c] : zero4;
    }
  };
  // ... split into the planes of ring stage `stage`: K at row `lane`, V transposed at the key's permuted
  // position in rows 8 * warp .. + 7.
  const int vpos = (lane & ~7) | ((lane & 1) << 2) | ((lane >> 1) & 3);
  auto store_tile = [&](int stage) {
    uint8_t* const st = smem + stage * kFwdStage;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * kChunks * warp + 4 * c;
      store_split4(st, st + kKPlane, plane_off(lane, col, kFwdKeys), kr[c]);
      const float x[4] = {vr[c].x, vr[c].y, vr[c].z, vr[c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = plane_off(col + e, vpos, kD);
        uint32_t hi, lo;
        split(x[e], hi, lo);
        *reinterpret_cast<uint32_t*>(st + 2 * kKPlane + off) = hi;
        *reinterpret_cast<uint32_t*>(st + 2 * kKPlane + kVPlane + off) = lo;
      }
    }
  };

  load_tile(0);
  store_tile(0);
  if (n_tiles > 1) load_tile(1);
  fence_proxy_async();  // the stage-0 planes, for the async proxy (wgmma)

  const uint64_t desc_ring = make_desc(base);
  constexpr uint64_t kKLo = kKPlane >> 4, kVHi = 2 * kKPlane >> 4, kVLo = kVHi + (kVPlane >> 4);
  auto stage_desc = [&](int tile) { return desc_ring + (uint64_t)((tile % kFwdStages) * (kFwdStage >> 4)); };

  float sacc[16];   // scores of the current tile (64 rows x 32 keys), then exp2(s - m)
  float pv[32];     // P V of the previous tile
  float oacc[32];   // running output
  FragA pa[4];      // P of the previous tile as A fragments, one per 8-key step
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  // Online-softmax state of this thread's two rows (g and g + 8 of its warp's 16): running max, and this
  // thread's partial running sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float alpha0, alpha1;

  auto start_scores = [&](int tile) {
    const uint64_t st = stage_desc(tile);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {  // head columns 8 ks .. + 7: column block ks / 4, 32 bytes a step
      const uint64_t ko = (ks >> 2) * (kKPlane >> 5) + (ks & 3) * 2;
      wgmma3_rs(sacc, qf[ks], st + ko, st + kKLo + ko, ks > 0);
    }
  };
  auto start_pv = [&](int tile) {  // from zero: the tile's sum is added on the CUDA cores
    const uint64_t st = stage_desc(tile);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma3_rs(pv, pa[kk], st + kVHi + 2 * kk, st + kVLo + 2 * kk, kk > 0);
  };
  // Under the products: tile + 1 into its stage, then the loads of tile + 2.
  auto stream = [&](int tile) {
    if (tile + 1 < n_tiles) {
      store_tile((tile + 1) % kFwdStages);
      fence_proxy_async();
      if (tile + 2 < n_tiles) load_tile(tile + 2);
    }
  };
  // sacc <- exp2(sacc - m_new); updates m and l; leaves the rescale factors in alpha0/1.
  auto softmax = [&](int tile) {
    if ((tile + 1) * kFwdKeys > skv) {  // ragged kv tail
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (tile * kFwdKeys + 8 * (i >> 2) + 2 * t + (i & 1) >= skv) sacc[i] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * kk], sacc[4 * kk + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * kk + 2], sacc[4 * kk + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    alpha0 = exp2f(m0 - mx0);  // 0 on the first tile
    alpha1 = exp2f(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sacc[4 * kk] = exp2f(sacc[4 * kk] - mx0);
      sacc[4 * kk + 1] = exp2f(sacc[4 * kk + 1] - mx0);
      sacc[4 * kk + 2] = exp2f(sacc[4 * kk + 2] - mx1);
      sacc[4 * kk + 3] = exp2f(sacc[4 * kk + 3] - mx1);
      rs0 += sacc[4 * kk] + sacc[4 * kk + 1];
      rs1 += sacc[4 * kk + 2] + sacc[4 * kk + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    m0 = mx0;
    m1 = mx1;
  };
  auto split_p = [&]() {  // k = t: key 2t of the step, k = t + 4: key 2t + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pa[kk] = split_a(sacc[4 * kk], sacc[4 * kk + 2], sacc[4 * kk + 1], sacc[4 * kk + 3]);
  };

  // Tile 0: S, softmax; its P V joins the next turn's products.
  __syncthreads();
  wgmma_fence();
  start_scores(0);
  wgmma_commit();
  stream(0);
  wgmma_wait<0>();
  reg_fence(sacc);
  softmax(0);
  split_p();

  for (int j = 1; j < n_tiles; ++j) {
    __syncthreads();  // tile j's planes are in; every warp is done with tile j - 2's stage
    reg_fence(sacc);
    reg_fence(pv);
    wgmma_fence();
    start_scores(j);
    wgmma_commit();
    start_pv(j - 1);
    wgmma_commit();
    stream(j);
    wgmma_wait<1>();  // S of tile j is there; P V of tile j - 1 may run on
    reg_fence(sacc);
    softmax(j);
    reg_fence(sacc);
    wgmma_wait<0>();
    reg_fence(pv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pa[kk].hi);
      reg_fence(pa[kk].lo);
    }
    // acc held O(j - 2) * alpha(j - 1): plus P V of tile j - 1 is O(j - 1), then rescaled for tile j
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      oacc[4 * jj] = (oacc[4 * jj] + pv[4 * jj]) * alpha0;
      oacc[4 * jj + 1] = (oacc[4 * jj + 1] + pv[4 * jj + 1]) * alpha0;
      oacc[4 * jj + 2] = (oacc[4 * jj + 2] + pv[4 * jj + 2]) * alpha1;
      oacc[4 * jj + 3] = (oacc[4 * jj + 3] + pv[4 * jj + 3]) * alpha1;
    }
    split_p();
  }

  reg_fence(pv);
  wgmma_fence();
  start_pv(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(pv);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    reg_fence(pa[kk].hi);
    reg_fence(pa[kk].lo);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] += pv[i];

  // The row sums over the 4 threads that share a row.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // O = acc / l; rows past sq are not stored.
  const int s_lo = row0, s_hi = row0 + 8;
  float* ob = o + ((long long)b * sq * heads + h) * kD;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (s_lo < sq)
      *reinterpret_cast<float2*>(ob + (long long)s_lo * stride + col) =
          make_float2(oacc[4 * jj] / l0, oacc[4 * jj + 1] / l0);
    if (s_hi < sq)
      *reinterpret_cast<float2*>(ob + (long long)s_hi * stride + col) =
          make_float2(oacc[4 * jj + 2] / l1, oacc[4 * jj + 3] / l1);
  }
  if (kWriteLse && t == 0) {  // one thread of each group of 4 writes the row's lse
    float* lb = lse + (long long)bh * sq;
    if (s_lo < sq) lb[s_lo] = m0 + log2f(l0);
    if (s_hi < sq) lb[s_hi] = m1 + log2f(l1);
  }
}

template <bool kWriteLse>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads, int sq,
               int skv, float qscale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<kWriteLse>, kFwdSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kFwdRows - 1) / kFwdRows, batch * heads);
  flash_fwd_f32_kernel<kWriteLse><<<grid, kFwdThreads, kFwdSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), heads, sq, skv, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's cudaError_t.

extern "C" int instantir_flash_fwd_f32_d64(const void* q, const void* k, const void* v, void* o, int batch,
                                           int heads, int sq, int skv, float qscale, void* stream) {
  return launch_fwd<false>(q, k, v, o, nullptr, batch, heads, sq, skv, qscale, stream);
}

// The training forward: also writes lse[B, H, Sq] (fp32, log2 domain).
extern "C" int instantir_flash_fwd_lse_f32_d64(const void* q, const void* k, const void* v, void* o, void* lse,
                                               int batch, int heads, int sq, int skv, float qscale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fwd<true>(q, k, v, o, lse, batch, heads, sq, skv, qscale, stream);
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

// Flash-attention backward for Hopper (sm_90a), bf16, head_dim 64: the dQ
// kernel and the dK/dV kernel.
//
// Replaces the two TPU kernels of instantir_tpu/ops/attention.py::_flash_backward
// (_flash_bwd_dq_kernel_resident / _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel_resident / _flash_bwd_dkv_kernel): the FlashAttention-2
// backward from the saved log2-domain logsumexp, with no bias or mask and no
// S x S tensor in device memory in either direction.
//
//   dQ_i = scale * sum_j [P_ij o (dO_i V_j^T - D_i)] K_j
//   dV_j = sum_i P_ij^T dO_i
//   dK_j = scale * sum_i [P_ij o (dO_i V_j^T - D_i)]^T Q_i
//   P_ij = exp2(s2_ij - lse2_i),  D_i = rowsum(dO_i o O_i) (fp32, computed outside)
//
// Numerics follow the Pallas bodies, not their blocking:
//   * dQ kernel: q2 = bf16(fp32(q) * scale*log2e); S = q2 K^T in fp32;
//     p = exp2(s - lse2) in fp32; dP = dO V^T in fp32; dS = bf16(p * (dp - D));
//     acc += dS K in fp32; dq = bf16(acc * scale)  -- scale, not scale*log2e.
//   * dK/dV kernel: k2 = bf16(fp32(k) * scale*log2e); S^T = k2 Q^T computed
//     directly, so P^T and dS^T come out in the accumulator's layout, which is
//     the layout of a register A operand; dv += bf16(p^T) dO; dP^T = V dO^T;
//     dS^T = bf16(p^T * (dp^T - D)); dk += dS^T Q; dk = bf16(acc * scale),
//     dv = bf16(acc).
//
// What bounds them on the H100 (head_dim 64, S = 1024..8192):
//   * operations: dQ does three S x S x 64 products (6*S^2*64 FLOP per
//     batch*head), dK/dV four (8*S^2*64), against O(S*64) bytes of operands:
//     hundreds of FLOP per byte, far above the ~295 FLOP/B ridge, so the bound
//     is the tensor cores' 989 TFLOP/s. Per 64x64 score tile and warpgroup,
//     dQ issues 12 wgmma m64n64k16 (32 SM clocks each: 384 clocks) and dK/dV
//     16 (512 clocks);
//   * exp2: the same tile needs 4,096 exp2, 16 a clock per SM by the usual
//     figure: 256 clocks. The forward (flash_fwd.cu) showed that on this card
//     the products and the exp2 pass of the CTAs on an SM run in turn, not
//     together; if they do here too, dQ stops near 384/640 = 60% of its
//     operations bound and dK/dV near 512/768 = 67% -- above the forward's
//     ~50%, because the products grow and the exp2 pass does not;
//   * L2 traffic: a dQ CTA streams all K and V of its (batch, head), a dK/dV
//     CTA all Q and dO plus lse2 and D: B*H*Sq*Skv*256/rows bytes per launch,
//     `rows` the q rows (keys) a CTA owns.
//
// Design. Every product is wgmma.mma_async m64n64k16 (bf16 -> fp32), in the two
// forms of hopper.cuh: A and B from shared memory, both K-major ("ss"); or A
// from registers and B from shared memory MN-major ("rs_bt", the transpose
// flag). wgmma reads B in either major-ness from one tile, so a tile staged
// once as [row][d] serves as X^T in one product and as X in another: there is
// no transposed copy anywhere.
//   * dQ: a CTA (one warpgroup) owns 64 q rows for the whole K/V sweep. S = q2 K^T and
//     dP = dO V^T are "ss" (q2 and dO staged once, the K and V tiles [key][d]
//     as K-major B); dQ += dS K is "rs_bt": dS is packed to bf16 in place from
//     the S accumulator (the accumulator layout is the A-fragment layout) and
//     K is the MN-major B. lse2 and D are per row: 4 registers per thread.
//   * dK/dV: a CTA (one warpgroup) owns 64 keys for the whole q sweep.
//     S^T = k2 Q^T and dP^T = V dO^T are "ss" (k2 and V staged once, the Q and
//     dO tiles [row][d] as K-major B); dV += P^T dO and dK += dS^T Q are
//     "rs_bt" with P^T and dS^T packed from the accumulators and dO and Q as
//     the MN-major B. lse2 and D are indexed by the accumulator's column
//     ((i>>2)*8 + 2t + (i&1) for element i of a thread's 32): 16 values each
//     per tile, read from shared memory, where they arrive with the tile.
//   * Streaming: the streamed tiles (K and V; Q and dO) come in by 16-byte
//     cp.async copies, made by all threads, into a 3-stage ring; rows past the
//     end are zero-filled by the copy's src-size operand. lse2 and D of a q
//     tile come in the same stage by 4-byte copies (lse + bh*sq is only 4-byte
//     aligned when sq % 4 != 0), never reading past the row. Each turn:
//     cp.async.wait_group -> fence.proxy.async -> __syncthreads -> start the
//     next copy into the stage that the barrier just freed. dQ holds tile j - 1
//     in the ring for its accumulation during turn j, so its copies run one
//     tile ahead (tile j + 1 into the stage of tile j - 2); dK/dV is done with
//     tile j - 1 at the barrier, so its copies run two tiles ahead (tile j + 2
//     into the stage of tile j - 1). The operands staged once go in by
//     st.shared in the same 128-byte swizzle (q2 and k2 scaled in fp32 and
//     rounded to bf16 on the way), fenced before the first wgmma.
//   * Overlap. dQ: the "ss" products of tile j are issued together with the
//     "rs_bt" accumulation of tile j - 1; the elementwise pass of tile j
//     starts once its two products are there, while the accumulation may
//     still run. dK/dV runs each tile's products, elementwise pass and
//     accumulation in turn: it keeps more registers live, and the overlap
//     there comes from the other CTAs on the SM. Empty asm register fences
//     around every wgmma.wait_group keep the compiler from moving plain
//     arithmetic across the wait.
//   * CTA shape: one warpgroup, three CTAs per SM, for both kernels. dQ keeps
//     112 accumulator and fragment registers live; a CTA of two warpgroups
//     spilled at the 128-register cap of two such CTAs per SM and, at one per
//     SM, ran slower than three 1-warpgroup CTAs at every main-path shape.
//     dK/dV keeps 160 live; two warpgroups per CTA (128 keys sharing one ring,
//     half the L2 traffic), or one warpgroup at two CTAs per SM with the
//     overlap of dQ, were slower at the training shapes (S = 1024 and 4096),
//     the only ones that launch it (tried on the H100; PERF.md).
//   * Ragged tails keep the earlier semantics: keys at or past skv read
//     K = V = 0 and get -inf scores in the dQ kernel (p = 0); q rows at or past
//     sq read q = dO = 0, lse2 = +inf (p = 0) and D = 0 in the dQ kernel, and
//     their score columns are set to -inf in the last q tile of the dK/dV
//     kernel (its zero-filled lse2 would otherwise give p = exp2(0 - 0) = 1,
//     harmless only because dO and Q are zero there too). Rows past the end
//     are not stored.
//
// Registers (ptxas, sm_90a, CUDA 12.8): dQ 142, dK/dV 159; no spills. Shared
// memory, dynamic, each with up to 1 KB of alignment slack:
//   dQ: [q2 8 KB][dO 8 KB][stage: K 8 KB, V 8 KB] x 3 = 66,560 B;
//   dK/dV: [k2 8 KB][V 8 KB][stage: Q 8 KB, dO 8 KB, lse2 and D 512 B] x 3
//   = 68,096 B.
//
// Layout: q, dO, dq [B, Sq, H, 64]; k, v, dk, dv [B, Skv, H, 64], contiguous
// (row stride H*64); lse2 and D fp32 [B, H, Sq].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;                       // head_dim
constexpr int kTile = 64;                    // rows of an owned tile (per warpgroup) and of a streamed tile
constexpr int kTileBytes = kTile * kD * 2;   // one 64-row tile of 128-byte rows
constexpr int kStageBytes = 2 * kTileBytes;  // two streamed tiles: K + V, or Q + dO
constexpr int kRowsBytes = 2 * kTile * 4;    // lse2 and D of one q tile
constexpr int kDqStages = 3;                 // K/V ring of the dQ kernel
constexpr int kDkvStages = 3;                // Q/dO ring of the dK/dV kernel

constexpr int kDqSmemBytes = 2 * kTileBytes + kDqStages * kStageBytes + 1024;
constexpr int kDkvSmemBytes = 2 * kTileBytes + kDkvStages * (kStageBytes + kRowsBytes) + 1024;

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Stage kRows rows (row0.., zero at or past `rows`) of a [B, S, H, 64] operand
// as consecutive swizzled 64-row tiles at `base`; `mul` != 1 scales in fp32 and
// rounds back to bf16.
template <int kThreads, int kRows>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, size_t row_stride, int row0, int rows,
                                           float mul, uint32_t base, int tid) {
  for (int c = tid; c < kRows * 8; c += kThreads) {
    const int r = c >> 3;
    const int ch = c & 7;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + ch * 8);
    if (mul != 1.f) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * mul);
    }
    st_shared_16(base + r * 128 + ((ch ^ (r & 7)) << 4), val);
  }
}

// Start the copies of one stage: rows row0..row0+63 of `a` and of `b` (zero at
// or past `rows`) into the two swizzled tiles at `stage`.
template <int kThreads>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* a, const __nv_bfloat16* b, size_t row_stride,
                                           int row0, int rows, uint32_t stage, int tid) {
  constexpr int kRowStep = kThreads / 8;  // rows one pass of all threads copies; a multiple of 8
  const int ld_row = tid >> 3;
  const int ld_ch = tid & 7;
  const uint32_t dst = stage + ld_row * 128 + ((ld_ch ^ (ld_row & 7)) << 4);
#pragma unroll
  for (int i = 0; i < kTile / kRowStep; ++i) {
    const int row = row0 + ld_row + i * kRowStep;
    const bool ok = row < rows;
    const size_t off = (size_t)(ok ? row : 0) * row_stride + ld_ch * 8;
    cp_async_16(dst + i * kRowStep * 128, a + off, ok ? 16 : 0);
    cp_async_16(dst + kTileBytes + i * kRowStep * 128, b + off, ok ? 16 : 0);
  }
}

// d = a b^T with a and b 64x64 tiles [row][d] in shared memory (K-major both).
__device__ __forceinline__ void mma_abt(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_ss(d, desc_a + 2 * ks, desc_b + 2 * ks, ks > 0);
}

// d += a b with a 64x64 in registers (4 A fragments of 16 columns) and b a
// 64x64 tile [k][n] in shared memory (MN-major: 16 rows = 2048 bytes per step).
__device__ __forceinline__ void mma_rb(float (&d)[32], const uint32_t (&a)[16], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs_bt(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_b + kk * (2048 >> 4));
}

// A fragments (bf16) of a 64x64 fp32 accumulator, packed in place.
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk] = pack_bf16x2(x[8 * kk], x[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(128, 3)
flash_bwd_dq_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int heads, int sq, int skv, int n_qtiles,
                             float qscale, float scale) {
  constexpr int kThreads = 128;
  constexpr int kStages = kDqStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_base = q_base + kTileBytes;
  const uint32_t ring_base = do_base + kTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  const int b = bh / heads;
  const int h = bh % heads;
  const size_t row_stride = (size_t)heads * kD;
  const size_t q_off = ((size_t)b * sq * heads + h) * kD;
  const size_t kv_off = ((size_t)b * skv * heads + h) * kD;
  const int n_tiles = (skv + kTile - 1) / kTile;

  auto load_tile = [&](int tile) {
    load_stage<kThreads>(k + kv_off, v + kv_off, row_stride, tile * kTile, skv,
                         ring_base + (tile % kStages) * kStageBytes, tid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  stage_rows<kThreads, kTile>(q + q_off, row_stride, q0, sq, qscale, q_base, tid);
  stage_rows<kThreads, kTile>(d_o + q_off, row_stride, q0, sq, 1.f, do_base, tid);

  // lse2 and D of this thread's two rows; past sq: p = exp2(-inf) = 0
  const int s_lo = q0 + warp * 16 + g;
  const int s_hi = s_lo + 8;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  const float lse0 = s_lo < sq ? lb[s_lo] : INFINITY;
  const float lse1 = s_hi < sq ? lb[s_hi] : INFINITY;
  const float dl0 = s_lo < sq ? db[s_lo] : 0.f;
  const float dl1 = s_hi < sq ? db[s_hi] : 0.f;

  const uint64_t desc_q = make_desc(q_base);
  const uint64_t desc_do = make_desc(do_base);
  const uint64_t desc_ring = make_desc(ring_base);

  float sacc[32];   // S, then dS in fp32
  float dpacc[32];  // dP
  float dqacc[32];  // dQ accumulator
  uint32_t dsa[16];  // dS in bf16, as 4 A fragments (16 keys each)
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = 0.f;

  auto start_s = [&](int tile) {  // S = q2 K^T, dP = dO V^T
    const uint64_t dk = desc_ring + (uint64_t)((tile % kStages) * (kStageBytes >> 4));
    mma_abt(sacc, desc_q, dk);
    mma_abt(dpacc, desc_do, dk + (kTileBytes >> 4));
  };
  auto start_dq = [&](int tile) {  // dQ += dS K
    mma_rb(dqacc, dsa, desc_ring + (uint64_t)((tile % kStages) * (kStageBytes >> 4)));
  };
  auto d_softmax = [&](int tile) {  // sacc <- p * (dp - D)
    const int k0 = tile * kTile;
    const bool ragged = tile == n_tiles - 1 && (skv % kTile);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float s = sacc[i];
      if (ragged && k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= skv) s = -INFINITY;
      const bool hi = i & 2;
      sacc[i] = ex2(s - (hi ? lse1 : lse0)) * (dpacc[i] - (hi ? dl1 : dl0));
    }
  };

  // Tile 0: its products, then dS; its dQ product joins the next turn's.
  cp_async_wait<kStages - 2>();
  fence_proxy_async();  // the staged q2 / dO and the landed tile, for the async proxy
  __syncthreads();
  wgmma_fence();
  start_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sacc);
  reg_fence(dpacc);
  d_softmax(0);
  pack_a(dsa, sacc);

  for (int j = 1; j < n_tiles; ++j) {
    cp_async_wait<kStages - 3>();  // tile j has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();  // ... everyone's; and every warp is done with tile j - 2
    if (j + kStages - 2 < n_tiles) load_tile(j + kStages - 2);
    cp_async_commit();

    reg_fence(sacc);
    reg_fence(dpacc);
    reg_fence(dqacc);
    reg_fence(dsa);
    wgmma_fence();
    start_s(j);
    wgmma_commit();
    start_dq(j - 1);
    wgmma_commit();
    wgmma_wait<1>();  // S and dP of tile j are there; dQ of tile j - 1 may run on
    reg_fence(sacc);
    reg_fence(dpacc);
    d_softmax(j);
    reg_fence(sacc);
    wgmma_wait<0>();
    reg_fence(dqacc);
    reg_fence(dsa);
    pack_a(dsa, sacc);
  }

  reg_fence(dqacc);
  reg_fence(dsa);
  wgmma_fence();
  start_dq(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(dqacc);

  __nv_bfloat16* qrow = dq + q_off;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = jj * 8 + t * 2;
    if (s_lo < sq) {
      *reinterpret_cast<uint32_t*>(qrow + (size_t)s_lo * row_stride + col) =
          pack_bf16x2(dqacc[4 * jj] * scale, dqacc[4 * jj + 1] * scale);
    }
    if (s_hi < sq) {
      *reinterpret_cast<uint32_t*>(qrow + (size_t)s_hi * row_stride + col) =
          pack_bf16x2(dqacc[4 * jj + 2] * scale, dqacc[4 * jj + 3] * scale);
    }
  }
}

__global__ void __launch_bounds__(128, 3)
flash_bwd_dkv_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads, int sq,
                              int skv, int n_ktiles, float kscale, float scale) {
  constexpr int kThreads = 128;
  constexpr int kStages = kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_base = k_base + kTileBytes;
  const uint32_t ring_base = v_base + kTileBytes;
  const uint32_t rows_base = ring_base + kStages * kStageBytes;
  const float* rows_ring = reinterpret_cast<const float*>(smem_raw + (rows_base - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kTile;
  const int b = bh / heads;
  const int h = bh % heads;
  const size_t row_stride = (size_t)heads * kD;
  const size_t q_off = ((size_t)b * sq * heads + h) * kD;
  const size_t kv_off = ((size_t)b * skv * heads + h) * kD;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  const int n_tiles = (sq + kTile - 1) / kTile;

  auto load_tile = [&](int tile) {
    const int stage = tile % kStages;
    load_stage<kThreads>(q + q_off, d_o + q_off, row_stride, tile * kTile, sq, ring_base + stage * kStageBytes, tid);
    // lse2 (threads 0..63) and D (64..127) of the tile's rows, zero past sq
    const int row = tile * kTile + (tid & (kTile - 1));
    const bool ok = row < sq;
    cp_async_4(rows_base + stage * kRowsBytes + tid * 4, (tid < kTile ? lb : db) + (ok ? row : 0), ok ? 4 : 0);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  stage_rows<kThreads, kTile>(k + kv_off, row_stride, k0, skv, kscale, k_base, tid);
  stage_rows<kThreads, kTile>(v + kv_off, row_stride, k0, skv, 1.f, v_base, tid);

  const uint64_t desc_k = make_desc(k_base);
  const uint64_t desc_v = make_desc(v_base);
  const uint64_t desc_ring = make_desc(ring_base);

  float sacc[32];   // S^T, then P^T in fp32
  float dpacc[32];  // dP^T, then dS^T in fp32
  float dkacc[32];
  float dvacc[32];
  uint32_t pa[16];   // P^T in bf16, as 4 A fragments (16 q rows each)
  uint32_t dsa[16];  // dS^T in bf16
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kStages;
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's copies)
    fence_proxy_async();  // ... and, on the first turn, the staged k2 / V, for the async proxy
    __syncthreads();      // ... everyone's; and every warp is done with tile i - 1
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    // S^T = k2 Q^T, dP^T = V dO^T
    const uint64_t dq = desc_ring + (uint64_t)(stage * (kStageBytes >> 4));
    wgmma_fence();
    mma_abt(sacc, desc_k, dq);
    mma_abt(dpacc, desc_v, dq + (kTileBytes >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);

    // sacc <- p^T, dpacc <- p^T * (dp^T - D); lse2 and D by column
    const float* rl = rows_ring + stage * (kRowsBytes / 4);
    const int q0 = i * kTile;
    const bool ragged = i == n_tiles - 1 && (sq % kTile);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = jj * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(rl + col);
      const float2 dd = *reinterpret_cast<const float2*>(rl + kTile + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * jj + e;
        float s = sacc[n];
        if (ragged && q0 + col + (e & 1) >= sq) s = -INFINITY;
        const float p = ex2(s - ((e & 1) ? l2.y : l2.x));
        sacc[n] = p;
        dpacc[n] = p * (dpacc[n] - ((e & 1) ? dd.y : dd.x));
      }
    }
    pack_a(pa, sacc);
    pack_a(dsa, dpacc);

    // dV += P^T dO, dK += dS^T Q
    reg_fence(pa);
    reg_fence(dsa);
    reg_fence(dkacc);
    reg_fence(dvacc);
    wgmma_fence();
    mma_rb(dvacc, pa, dq + (kTileBytes >> 4));
    mma_rb(dkacc, dsa, dq);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dkacc);
    reg_fence(dvacc);
    reg_fence(pa);
    reg_fence(dsa);
  }

  const int s_lo = k0 + warp * 16 + g;
  const int s_hi = s_lo + 8;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = jj * 8 + t * 2;
    if (s_lo < skv) {
      const size_t off = kv_off + (size_t)s_lo * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dkacc[4 * jj] * scale, dkacc[4 * jj + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dvacc[4 * jj], dvacc[4 * jj + 1]);
    }
    if (s_hi < skv) {
      const size_t off = kv_off + (size_t)s_hi * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dkacc[4 * jj + 2] * scale, dkacc[4 * jj + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dvacc[4 * jj + 2], dvacc[4 * jj + 3]);
    }
  }
}

int launch_dq(const void* q, const void* k, const void* v, const void* d_o, const void* lse, const void* delta,
              void* dq, int batch, int heads, int sq, int skv, float qscale, float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_d64_kernel, kDqSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kTile - 1) / kTile;
  flash_bwd_dq_bf16_d64_kernel<<<(unsigned)(n_qtiles * batch * heads), 128, kDqSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), heads, sq, skv, n_qtiles, qscale, scale);
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* d_o, const void* lse, const void* delta,
               void* dk, void* dv, int batch, int heads, int sq, int skv, float kscale, float scale,
               cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_d64_kernel, kDkvSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (skv + kTile - 1) / kTile;
  flash_bwd_dkv_bf16_d64_kernel<<<(unsigned)(n_ktiles * batch * heads), 128, kDkvSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads,
      sq, skv, n_ktiles, kscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it never synchronises.
// qscale = scale*log2(e) (applied to q or k before the score product), scale
// the softmax scale (applied to the dq / dk accumulators).
extern "C" int instantir_flash_bwd_dq_bf16_d64(const void* q, const void* k, const void* v, const void* d_o,
                                               const void* lse, const void* delta, void* dq, int batch,
                                               int heads, int sq, int skv, float qscale, float scale,
                                               void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  return launch_dq(q, k, v, d_o, lse, delta, dq, batch, heads, sq, skv, qscale, scale,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int instantir_flash_bwd_dkv_bf16_d64(const void* q, const void* k, const void* v, const void* d_o,
                                                const void* lse, const void* delta, void* dk, void* dv,
                                                int batch, int heads, int sq, int skv, float qscale,
                                                float scale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  return launch_dkv(q, k, v, d_o, lse, delta, dk, dv, batch, heads, sq, skv, qscale, scale,
                    static_cast<cudaStream_t>(stream));
}

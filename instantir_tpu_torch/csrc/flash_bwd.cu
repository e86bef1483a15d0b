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
//     directly, so P^T and dS^T come out as left-hand mma operands with no
//     transpose; dv += bf16(p^T) dO; dP^T = V dO^T; dS^T = bf16(p^T * (dp^T - D));
//     dk += dS^T Q; dk = bf16(acc * scale), dv = bf16(acc).
//
// What bounds them on the H100: dQ does three S x S x 64 products (6*S^2*64
// FLOP per batch*head), dK/dV four (8*S^2*64), against O(S*64) bytes of
// operands -- hundreds of FLOP per byte at S >= 1024, far above the ~295
// FLOP/B ridge, so both are bound by tensor-core operations (989 TFLOP/s dense
// bf16) and then by the exp2 pass over each score tile.
//
// Design (a simple one that is right first), shared with flash_fwd.cu: one
// CTA of 4 warps, each warp owning 16 rows of the CTA's 64-row tile, products
// on the tensor cores with mma.sync m16n8k16 bf16 -> fp32, accumulators in
// registers, nothing crossing CTAs and no atomics.
//   * dQ: the CTA owns a 64-row q tile for the whole K/V sweep. q2 and dO are
//     staged once and kept as A fragments. Each 64-key K/V tile is staged in
//     shared memory as K [key][d] and V [key][d] (right-hand operands of
//     S = q2 K^T and dP = dO V^T) plus a transposed copy K^T [d][key], because
//     dQ += dS K takes K untransposed as the right-hand operand, whose mma
//     fragment wants two consecutive keys per 32-bit load.
//   * dK/dV: the CTA owns a 64-row K/V tile and sweeps the q tiles. k2 and V
//     are staged once and kept as A fragments. Each 64-row q tile is staged as
//     Q [row][d] and dO [row][d] (right-hand operands of S^T = k2 Q^T and
//     dP^T = V dO^T) plus transposed copies Q^T [d][row] and dO^T [d][row] for
//     dK += dS^T Q and dV += P^T dO; lse2 and D of the tile sit in shared
//     memory, indexed by score column.
// Rows are padded to 72 elements so fragment loads are free of bank conflicts.
// Ragged tails: K/V rows at or past kv_len are zero-filled and their scores
// set to -inf (p = 0); q rows at or past sq read q = dO = 0, lse2 = +inf (so
// p = exp2(-inf) = 0) and D = 0, and contribute nothing; rows past the end are
// not stored. TMA, wgmma, ldmatrix, double buffering and warp specialisation
// are left for later work.
//
// Layout: q, dO, dq [B, Sq, H, 64]; k, v, dk, dv [B, Skv, H, 64], contiguous
// (row stride H*64); lse2 and D fp32 [B, H, Sq].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;       // head_dim
constexpr int kTile = 64;    // rows of the owned tile and of each streamed tile
constexpr int kWarps = 4;    // 16 owned rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = 72;   // padded smem row pitch in bf16 elements

__device__ __forceinline__ uint32_t ld_smem_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a (16x16, row) * b (16x8, col) + d; bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_m16n8k16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage a [64, 64] tile (rows row0.. of `src`, zero past `rows`) into `dst`
// as [row][d]; with `dst_t` also transposed as [d][row]; `mul` != 1 scales in
// fp32 and rounds back to bf16.
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ src, size_t row_stride, int row0,
                                           int rows, float mul, __nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                           int tid) {
  for (int c = tid; c < kTile * (kD / 8); c += kThreads) {
    const int r = c >> 3;
    const int ch = c & 7;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + ch * 8);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
    if (mul != 1.0f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * mul);
    }
    *reinterpret_cast<uint4*>(&dst[r * kPitch + ch * 8]) = val;
    if (dst_t != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(ch * 8 + i) * kPitch + r] = e[i];
    }
  }
}

// This warp's 16 rows of a staged [row][d] tile as mma A fragments
// (4 k-steps of 16 along head_dim).
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile, int r0, int t, uint32_t f[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c0 = ks * 16 + t * 2;
    f[ks][0] = ld_smem_u32(&tile[r0 * kPitch + c0]);
    f[ks][1] = ld_smem_u32(&tile[(r0 + 8) * kPitch + c0]);
    f[ks][2] = ld_smem_u32(&tile[r0 * kPitch + c0 + 8]);
    f[ks][3] = ld_smem_u32(&tile[(r0 + 8) * kPitch + c0 + 8]);
  }
}

// c[16 x 64] = a[16 x 64] * tile^T, with `tile` staged as [n][d]: n-tile j of
// the result takes rows j*8.. of `tile` as the right-hand operand.
__device__ __forceinline__ void mma_a_tile_t(float c[8][4], const uint32_t a[4][4], const __nv_bfloat16* tile,
                                             int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const int n = j * 8 + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bf[2];
      const int d0 = ks * 16 + t * 2;
      bf[0] = ld_smem_u32(&tile[n * kPitch + d0]);
      bf[1] = ld_smem_u32(&tile[n * kPitch + d0 + 8]);
      mma_m16n8k16(c[j], a[ks], bf);
    }
  }
}

// acc[16 x 64] += bf16(x)[16 x 64] * m[64 x 64], with `x` an fp32 score-shaped
// fragment re-packed as the A operand and `m` staged transposed as [d][k].
__device__ __forceinline__ void mma_c_tile(float acc[8][4], const float x[8][4], const __nv_bfloat16* tile_t,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int k0 = kk * 16 + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bf[2];
      const int dd = j * 8 + g;
      bf[0] = ld_smem_u32(&tile_t[dd * kPitch + k0]);
      bf[1] = ld_smem_u32(&tile_t[dd * kPitch + k0 + 8]);
      mma_m16n8k16(acc[j], a, bf);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int heads, int sq, int skv, float qscale,
                             float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_k[kTile * kPitch];   // [key][d]; stages q first
  __shared__ __align__(16) __nv_bfloat16 s_v[kTile * kPitch];   // [key][d]; stages dO first
  __shared__ __align__(16) __nv_bfloat16 s_kt[kD * kPitch];     // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t q_off = ((size_t)b * sq * heads + h) * kD;
  const size_t kv_off = ((size_t)b * skv * heads + h) * kD;

  stage_tile(q + q_off, row_stride, q0, sq, qscale, s_k, nullptr, tid);
  stage_tile(d_o + q_off, row_stride, q0, sq, 1.0f, s_v, nullptr, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[4][4];
  uint32_t dof[4][4];
  load_a_frags(s_k, r0, t, qf);
  load_a_frags(s_v, r0, t, dof);

  // lse2 and D of this thread's two rows (r0 and r0 + 8); past sq: p = 0
  const int s_lo = q0 + r0;
  const int s_hi = s_lo + 8;
  const float* lb = lse + (size_t)blockIdx.y * sq;
  const float* db = delta + (size_t)blockIdx.y * sq;
  const float lse0 = s_lo < sq ? lb[s_lo] : INFINITY;
  const float lse1 = s_hi < sq ? lb[s_hi] : INFINITY;
  const float dl0 = s_lo < sq ? db[s_lo] : 0.f;
  const float dl1 = s_hi < sq ? db[s_hi] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and with the staged q/dO)
    stage_tile(k + kv_off, row_stride, k0, skv, 1.0f, s_k, s_kt, tid);
    stage_tile(v + kv_off, row_stride, k0, skv, 1.0f, s_v, nullptr, tid);
    __syncthreads();

    float sc[8][4];
    float dp[8][4];
    mma_a_tile_t(sc, qf, s_k, g, t);   // S = q2 K^T
    mma_a_tile_t(dp, dof, s_v, g, t);  // dP = dO V^T
    const bool ragged = k0 + kTile > skv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e];
        if (ragged && k0 + j * 8 + t * 2 + (e & 1) >= skv) s = -INFINITY;
        const float p = exp2f(s - (e < 2 ? lse0 : lse1));
        sc[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));  // dS, rounded to bf16 when packed
      }
    }
    mma_c_tile(acc, sc, s_kt, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t * 2;
    if (s_lo < sq) {
      *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)s_lo * row_stride + col) =
          pack_bf16x2(acc[j][0] * scale, acc[j][1] * scale);
    }
    if (s_hi < sq) {
      *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)s_hi * row_stride + col) =
          pack_bf16x2(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads, int sq,
                              int skv, float kscale, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_q[kTile * kPitch];    // [row][d]; stages k2 first
  __shared__ __align__(16) __nv_bfloat16 s_do[kTile * kPitch];   // [row][d]; stages V first
  __shared__ __align__(16) __nv_bfloat16 s_qt[kD * kPitch];      // [d][row]
  __shared__ __align__(16) __nv_bfloat16 s_dot[kD * kPitch];     // [d][row]
  __shared__ float s_lse[kTile];
  __shared__ float s_delta[kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kTile;
  const size_t row_stride = (size_t)heads * kD;
  const size_t q_off = ((size_t)b * sq * heads + h) * kD;
  const size_t kv_off = ((size_t)b * skv * heads + h) * kD;
  const float* lb = lse + (size_t)blockIdx.y * sq;
  const float* db = delta + (size_t)blockIdx.y * sq;

  stage_tile(k + kv_off, row_stride, k0, skv, kscale, s_q, nullptr, tid);
  stage_tile(v + kv_off, row_stride, k0, skv, 1.0f, s_do, nullptr, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t kf[4][4];
  uint32_t vf[4][4];
  load_a_frags(s_q, r0, t, kf);
  load_a_frags(s_do, r0, t, vf);

  float dk_acc[8][4];
  float dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and with the staged k2/V)
    stage_tile(q + q_off, row_stride, q0, sq, 1.0f, s_q, s_qt, tid);
    stage_tile(d_o + q_off, row_stride, q0, sq, 1.0f, s_do, s_dot, tid);
    if (tid < kTile) {
      const int s = q0 + tid;
      s_lse[tid] = s < sq ? lb[s] : INFINITY;  // past sq: p = exp2(-inf) = 0
      s_delta[tid] = s < sq ? db[s] : 0.f;
    }
    __syncthreads();

    float sc[8][4];
    mma_a_tile_t(sc, kf, s_q, g, t);  // S^T = k2 Q^T: rows are keys, columns q rows
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = exp2f(sc[j][e] - s_lse[j * 8 + t * 2 + (e & 1)]);
    }
    mma_c_tile(dv_acc, sc, s_dot, g, t);  // dV += bf16(P^T) dO

    float dp[8][4];
    mma_a_tile_t(dp, vf, s_do, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= dp[j][e] - s_delta[j * 8 + t * 2 + (e & 1)];
    }
    mma_c_tile(dk_acc, sc, s_qt, g, t);  // dK += bf16(dS^T) Q
  }

  const int s_lo = k0 + r0;
  const int s_hi = s_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t * 2;
    if (s_lo < skv) {
      const size_t off = kv_off + (size_t)s_lo * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dv_acc[j][0], dv_acc[j][1]);
    }
    if (s_hi < skv) {
      const size_t off = kv_off + (size_t)s_hi * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

bool bad_shape(int batch, int heads, int sq, int skv) {
  return batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || (long long)batch * heads > 65535;
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
  const dim3 grid((sq + kTile - 1) / kTile, batch * heads);
  flash_bwd_dq_bf16_d64_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), heads,
      sq, skv, qscale, scale);
  return (int)cudaGetLastError();
}

extern "C" int instantir_flash_bwd_dkv_bf16_d64(const void* q, const void* k, const void* v, const void* d_o,
                                                const void* lse, const void* delta, void* dk, void* dv,
                                                int batch, int heads, int sq, int skv, float qscale,
                                                float scale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  const dim3 grid((skv + kTile - 1) / kTile, batch * heads);
  flash_bwd_dkv_bf16_d64_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, sq, skv, qscale, scale);
  return (int)cudaGetLastError();
}

// Flash-attention forward for Hopper (sm_90a), bf16, head_dim 64.
//
// Replaces the TPU kernel instantir_tpu/ops/attention.py::flash_attention
// (_flash_kernel_resident / _flash_kernel): softmax(q k^T * scale) v with no
// bias or mask, computed blockwise with an online softmax in the log2 domain.
// A second entry point of the same kernel (template flag kWriteLse) replaces
// ::_flash_forward_lse (_flash_fwd_lse_kernel_resident / _flash_fwd_lse_kernel),
// the training forward: it also stores, per q row, the log2-domain logsumexp
// lse2 = m + log2(l) in fp32 as lse[B, H, Sq], from which the backward
// kernels (flash_bwd.cu) rebuild P = exp2(s2 - lse2). Rows at or past sq of a
// ragged last tile are not stored; kv_len >= 1 (checked by the entry point)
// and never visiting a tile that lies wholly past kv_len mean every row has
// l > 0, so lse2 is finite.
//
// Numerics follow the Pallas kernel, not its blocking:
//   * q is multiplied by scale*log2(e) in fp32 and rounded back to bf16;
//   * S = q k^T accumulates in fp32 (tensor cores, bf16 inputs);
//   * the running max m and sum l are fp32 and use exp2;
//   * P is rounded to bf16 before P v, which accumulates in fp32;
//   * O = acc / l is stored in bf16.
//
// What bounds it on the H100 (head_dim 64, S = 1024..8192):
//   * operations: 4*S^2*64 FLOP per (batch, head) against 4*S*64*2 bytes of
//     q/k/v/o is ~S/2 FLOP per byte, far above the card's ~295 FLOP/B ridge, so
//     the bound is the tensor cores' 989 TFLOP/s. Per 64x64 score tile the
//     two products are 8 wgmma m64n64k16, 32 clocks each: 256 clocks of an SM;
//   * exp2: the same tile needs 4,096 exp2 on the special-function units, 16
//     results per clock per SM by the usual figure: 256 clocks again, 8 per
//     warp instruction. A kernel whose products and softmax take turns stops
//     near half of its operations bound; this one does (see PERF.md);
//   * L2 traffic: every CTA streams all K and V of its (batch, head), so a
//     launch reads B*H*S^2*256/rows bytes from L2 with `rows` q rows per CTA:
//     0.67 GB at B=2, S=4096, H=10 with 128 rows (1.34 GB with 64).
//
// Design.
//   * One CTA = kWG warpgroups (1 or 2), each owning 64 q rows. The entry
//     point counts the waves either choice needs (2 CTAs of 128 rows or 3 of
//     64 per SM) and takes 128 rows unless 64 fill the card better.
//   * Both products are wgmma.mma_async m64n64k16 (bf16 -> fp32). S = Q K^T
//     reads Q and K from shared memory (both K-major). O += P V takes P from
//     registers (the score accumulator, after the softmax, packed to bf16 in
//     place: the accumulator layout is the A-fragment layout) and V from
//     shared memory as it arrives, [key][d], as an MN-major B operand (the
//     instruction's transpose flag): no transposed copy.
//   * Shared-memory tiles are 64 rows of 128 bytes in the 128-byte swizzle
//     (16-byte chunk c of row r lies at chunk c ^ (r % 8)), base aligned to
//     1024 bytes, descriptors with layout type B128 and a stride of 1024
//     bytes between 8-row groups; no padding.
//   * K and V tiles of 64 keys come in by 16-byte cp.async copies, made by
//     all threads, into a ring of kStages stages (K tile + V tile each), two
//     tiles ahead of the one being multiplied; rows at or past kv_len are
//     zero-filled by the copy's src-size operand. Each turn of the loop:
//     cp.async.wait_group -> fence.proxy.async (wgmma reads shared memory
//     through the async proxy) -> __syncthreads -> start the copy of tile
//     j + kStages - 2 into the stage that tile j - 2 left.
//   * Q K^T of tile j and P V of tile j - 1 are started together; the softmax
//     of tile j starts when S is there, while P V may still run. Two CTAs
//     (or three) are resident per SM so that one's products can run under
//     another's softmax.
//   * The running sum l stays a per-thread partial sum until the epilogue;
//     the row maximum is reduced over the 4 threads of a row every tile.
//
// Shared memory: [Q: kWG x 8 KB][stage 0: K 8 KB, V 8 KB] ... [stage kStages-1],
// plus up to 1 KB of alignment slack.
//
// Layout: q [B, Sq, H, 64], k/v [B, Skv, H, 64], o [B, Sq, H, 64], all
// contiguous; each (b, h) row is 128 contiguous bytes at a stride of H*64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;                       // head_dim
constexpr int kBlockK = 64;                  // keys per K/V tile
constexpr int kStages = 4;                   // K/V ring depth
constexpr int kTileBytes = 64 * kD * 2;      // one 64-row tile of 128-byte rows
constexpr int kStageBytes = 2 * kTileBytes;  // K tile + V tile

template <int kWG>
constexpr int smem_bytes() {
  return kWG * kTileBytes + kStages * kStageBytes + 1024;
}

template <int kWG, bool kWriteLse>
__global__ void __launch_bounds__(kWG * 128, kWG == 2 ? 2 : 3)
flash_fwd_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int heads, int sq, int skv, int n_qtiles, float qscale) {
  constexpr int kThreads = kWG * 128;
  constexpr int kRows = kWG * 64;                 // q rows per CTA
  constexpr int kRowStep = kThreads / 8;          // rows one pass of all threads copies
  constexpr int kCopies = kBlockK / kRowStep;     // 16-byte copies per thread per K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring_base = q_base + kWG * kTileBytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const size_t row_stride = (size_t)heads * kD;

  const __nv_bfloat16* qb = q + ((size_t)b * sq * heads + h) * kD;
  const __nv_bfloat16* kb = k + ((size_t)b * skv * heads + h) * kD;
  const __nv_bfloat16* vb = v + ((size_t)b * skv * heads + h) * kD;
  __nv_bfloat16* ob = o + ((size_t)b * sq * heads + h) * kD;

  const int n_tiles = (skv + kBlockK - 1) / kBlockK;

  // This thread's share of every K/V tile: chunk ld_ch of rows ld_row + i*kRowStep.
  const int ld_row = tid >> 3;
  const int ld_ch = tid & 7;
  const uint32_t ld_off = ld_row * 128 + ((ld_ch ^ (ld_row & 7)) << 4);  // kRowStep % 8 == 0: the swizzle holds for every i

  auto load_tile = [&](int tile) {
    const uint32_t st = ring_base + (tile % kStages) * kStageBytes + ld_off;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int key = tile * kBlockK + ld_row + i * kRowStep;
      const bool ok = key < skv;
      const size_t goff = (size_t)(ok ? key : 0) * row_stride + ld_ch * 8;
      cp_async_16(st + i * kRowStep * 128, kb + goff, ok ? 16 : 0);
      cp_async_16(st + kTileBytes + i * kRowStep * 128, vb + goff, ok ? 16 : 0);
    }
  };

  // Start the ring: tiles 0 .. kStages-2, one commit group each (empty where there is no tile).
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // Stage the q tile, pre-scaled by scale*log2(e) in fp32 and rounded to bf16.
  for (int c = tid; c < kRows * 8; c += kThreads) {
    const int r = c >> 3;
    const int ch = c & 7;
    const int s = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)s * row_stride + ch * 8);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(q_base + r * 128 + ((ch ^ (r & 7)) << 4)),
                 "r"(val.x), "r"(val.y), "r"(val.z), "r"(val.w)
                 : "memory");
  }

  const uint64_t desc_q = make_desc(q_base + wg * kTileBytes);
  const uint64_t desc_ring = make_desc(ring_base);

  float sacc[32];  // scores of the current tile, then exp2(s - m)
  float oacc[32];  // output accumulator
  uint32_t pa[16];  // P in bf16, as 4 A fragments (16 keys each)
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  // Online-softmax state of this thread's two rows (g and g + 8 of its warp's
  // 16): running max, and this thread's partial running sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float alpha0, alpha1;

  auto start_qk = [&](int tile) {
    const uint64_t dk = desc_ring + (uint64_t)((tile % kStages) * (kStageBytes >> 4));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_ss(sacc, desc_q + 2 * ks, dk + 2 * ks, ks > 0);
  };
  auto start_pv = [&](int tile) {
    const uint64_t dv = desc_ring + (uint64_t)((tile % kStages) * (kStageBytes >> 4) + (kTileBytes >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_bt(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                            dv + kk * ((16 * 128) >> 4));
  };
  // sacc <- exp2(sacc - m_new); updates m and l; leaves the rescale factors in alpha0/1.
  auto softmax = [&](int tile) {
    if (tile == n_tiles - 1 && (skv % kBlockK)) {  // ragged kv tail
      const int k0 = tile * kBlockK;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (k0 + (i >> 2) * 8 + t * 2 + (i & 1) >= skv) sacc[i] = -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    alpha0 = ex2(m0 - mx0);
    alpha1 = ex2(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sacc[4 * j] = ex2(sacc[4 * j] - mx0);
      sacc[4 * j + 1] = ex2(sacc[4 * j + 1] - mx0);
      sacc[4 * j + 2] = ex2(sacc[4 * j + 2] - mx1);
      sacc[4 * j + 3] = ex2(sacc[4 * j + 3] - mx1);
      rs0 += sacc[4 * j] + sacc[4 * j + 1];
      rs1 += sacc[4 * j + 2] + sacc[4 * j + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    m0 = mx0;
    m1 = mx1;
  };
  // P (rounded to bf16) re-packed from the score accumulator as A fragments.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[4 * kk] = pack_bf16x2(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  };

  // Tile 0: S = Q K^T, softmax; its P V joins the next turn's products.
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
  wgmma_fence();
  start_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sacc);
  softmax(0);
  pack_p();

  for (int j = 1; j < n_tiles; ++j) {
    cp_async_wait<kStages - 3>();  // tile j has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();  // ... everyone's; and every warp is done with tile j - 2
    if (j + kStages - 2 < n_tiles) load_tile(j + kStages - 2);
    cp_async_commit();

    reg_fence(sacc);
    reg_fence(oacc);
    reg_fence(pa);
    wgmma_fence();
    start_qk(j);
    wgmma_commit();
    start_pv(j - 1);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j is there; P V of tile j - 1 may run on
    reg_fence(sacc);
    softmax(j);
    reg_fence(sacc);
    wgmma_wait<0>();
    reg_fence(oacc);
    reg_fence(pa);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      oacc[4 * jj] *= alpha0;
      oacc[4 * jj + 1] *= alpha0;
      oacc[4 * jj + 2] *= alpha1;
      oacc[4 * jj + 3] *= alpha1;
    }
    pack_p();
  }

  reg_fence(oacc);
  reg_fence(pa);
  wgmma_fence();
  start_pv(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(oacc);

  // The row sums over the 4 threads that share a row.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // O = acc / l in bf16; rows past sq are not stored.
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int s_lo = q0 + wg * 64 + warp * 16 + g;
  const int s_hi = s_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t * 2;
    if (s_lo < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)s_lo * row_stride + col) =
          pack_bf16x2(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    }
    if (s_hi < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)s_hi * row_stride + col) =
          pack_bf16x2(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
  }
  if (kWriteLse && t == 0) {  // one thread of each group of 4 writes the row's lse
    float* lb = lse + (size_t)bh * sq;  // [B, H, Sq]
    if (s_lo < sq) lb[s_lo] = m0 + log2f(l0);
    if (s_hi < sq) lb[s_hi] = m1 + log2f(l1);
  }
}

template <int kWG, bool kWriteLse>
int launch_variant(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads, int sq,
                   int skv, float qscale, cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_d64_kernel<kWG, kWriteLse>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, smem_bytes<kWG>(), configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kWG * 64 - 1) / (kWG * 64);
  kernel<<<(unsigned)(n_qtiles * batch * heads), kWG * 128, smem_bytes<kWG>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), heads, sq,
      skv, n_qtiles, qscale);
  return (int)cudaGetLastError();
}

// Rows of q per CTA, from the waves each choice needs. 128 rows (two
// warpgroups share the K/V ring: half the L2 traffic) run 2 CTAs per SM, 64
// rows run 3, and a warpgroup takes the same time per tile either way, so a
// wave of 128-row CTAs costs 4 units against 3 for a wave of 64-row CTAs.
__host__ int warpgroups_per_cta(int sq, long long batch_heads, int sms) {
  const long long ctas128 = (long long)((sq + 127) / 128) * batch_heads;
  const long long ctas64 = (long long)((sq + 63) / 64) * batch_heads;
  const long long waves128 = (ctas128 + 2LL * sms - 1) / (2LL * sms);
  const long long waves64 = (ctas64 + 3LL * sms - 1) / (3LL * sms);
  return 3 * waves64 < 4 * waves128 ? 1 : 2;
}

template <bool kWriteLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
                     int sq, int skv, float qscale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int sm_count[kMaxDevices] = {};
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return warpgroups_per_cta(sq, (long long)batch * heads, sm_count[device]) == 2
             ? launch_variant<2, kWriteLse>(q, k, v, o, lse, batch, heads, sq, skv, qscale, s)
             : launch_variant<1, kWriteLse>(q, k, v, o, lse, batch, heads, sq, skv, qscale, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int instantir_flash_fwd_bf16_d64(const void* q, const void* k, const void* v, void* o,
                                            int batch, int heads, int sq, int skv, float qscale,
                                            void* stream) {
  return launch_flash_fwd<false>(q, k, v, o, nullptr, batch, heads, sq, skv, qscale, stream);
}

// The training forward: also writes lse[B, H, Sq] (fp32, log2 domain).
extern "C" int instantir_flash_fwd_lse_bf16_d64(const void* q, const void* k, const void* v, void* o,
                                                void* lse, int batch, int heads, int sq, int skv,
                                                float qscale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_flash_fwd<true>(q, k, v, o, lse, batch, heads, sq, skv, qscale, stream);
}

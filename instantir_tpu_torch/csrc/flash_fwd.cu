// Flash-attention forward for Hopper (sm_90a), bf16, head_dim 64.
//
// Replaces the TPU kernel instantir_tpu/ops/attention.py::flash_attention
// (_flash_kernel_resident / _flash_kernel): softmax(q k^T * scale) v with no
// bias or mask, computed blockwise with an online softmax in the log2 domain.
// A second entry point of the same kernel (template flag kWriteLse) replaces
// ::_flash_forward_lse (_flash_fwd_lse_kernel_resident / _flash_fwd_lse_kernel),
// the training forward: it also stores, per q row, the log2-domain logsumexp
// lse2 = m + log2(l) in fp32 as lse[B, H, Sq], from which the backward
// kernels (flash_bwd.cu) rebuild P = exp2(s2 - lse2). That is one more 4-byte
// store per q row, so its bound is the forward's. Rows at or past sq of a
// ragged last tile are not stored; kv_len >= 1 (checked by the entry point)
// means every row has l > 0, so lse2 is finite.
//
// Numerics follow the Pallas kernel, not its blocking:
//   * q is multiplied by scale*log2(e) in fp32 and rounded back to bf16;
//   * S = q k^T accumulates in fp32 (tensor cores, bf16 inputs);
//   * the running max m and sum l are fp32 and use exp2;
//   * P is rounded to bf16 before P v, which accumulates in fp32;
//   * O = acc / l is stored in bf16.
//
// What bounds it on the H100: at the main path's shapes (S = 1024..8192,
// head_dim 64) the work is 4*S^2*D FLOP per (batch, head) against 4*S*D*2
// bytes of q/k/v/o, i.e. ~S/2 FLOP per byte -- far above the ~295 FLOP/B ridge,
// so the kernel is bound by tensor-core operations (989 TFLOP/s dense bf16),
// and secondarily by the exp2/max/sum passes over each [64, 64] score tile.
// Per 1024² restore at 30 steps it does ~1.28e14 FLOP in 4,074 launches, a
// bound of ~0.13 s; per call at B=2: S=8192/H=10 0.35 ms, S=4096/H=10
// 0.087 ms, S=2048/H=20 0.043 ms, S=1024/H=20 0.011 ms.
//
// Design (a simple one that is right first): one CTA of 4 warps per
// (batch*head, 64-row q tile); each warp owns 16 q rows. The q tile is scaled,
// staged through shared memory once and kept in registers as mma A fragments.
// K/V walk in 64-key tiles staged through shared memory (V stored transposed
// so every mma B fragment is one 32-bit load); Q K^T and P V run on the tensor
// cores with mma.sync m16n8k16 bf16 -> fp32. P never leaves registers: the
// score accumulator fragment is re-packed as the A fragment of P V. Rows are
// padded to 72 elements so fragment loads are free of bank conflicts.
// Ragged tails are masked: keys at or past kv_len score -inf (and their K/V
// rows are zero-filled), q rows at or past sq are computed on zeros and not
// stored. TMA, wgmma, warp specialisation and K/V double buffering are left
// for later work.
//
// Layout: q [B, Sq, H, 64], k/v [B, Skv, H, 64], o [B, Sq, H, 64], all
// contiguous; each (b, h) row is 128 contiguous bytes at a stride of H*64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head_dim
constexpr int kBlockQ = 64;   // q rows per CTA
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = 72;    // padded smem row pitch in bf16 elements

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

template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int heads, int sq, int skv, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 s_q[kBlockQ * kPitch];
  __shared__ __align__(16) __nv_bfloat16 s_k[kBlockK * kPitch];
  __shared__ __align__(16) __nv_bfloat16 s_vt[kD * kPitch];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group id: fragment row (A/C) or column (B)
  const int t = lane & 3;   // thread in group
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t row_stride = (size_t)heads * kD;

  const __nv_bfloat16* qb = q + ((size_t)b * sq * heads + h) * kD;
  const __nv_bfloat16* kb = k + ((size_t)b * skv * heads + h) * kD;
  const __nv_bfloat16* vb = v + ((size_t)b * skv * heads + h) * kD;
  __nv_bfloat16* ob = o + ((size_t)b * sq * heads + h) * kD;

  // Stage the q tile, pre-scaled by scale*log2(e) in fp32 and rounded to bf16.
  for (int c = tid; c < kBlockQ * (kD / 8); c += kThreads) {
    const int r = c >> 3;
    const int ch = c & 7;
    const int s = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)s * row_stride + ch * 8);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    *reinterpret_cast<uint4*>(&s_q[r * kPitch + ch * 8]) = val;
  }
  __syncthreads();

  // q as mma A fragments: 4 k-steps of 16 along head_dim.
  uint32_t qf[4][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c0 = ks * 16 + t * 2;
    qf[ks][0] = ld_smem_u32(&s_q[r0 * kPitch + c0]);
    qf[ks][1] = ld_smem_u32(&s_q[(r0 + 8) * kPitch + c0]);
    qf[ks][2] = ld_smem_u32(&s_q[r0 * kPitch + c0 + 8]);
    qf[ks][3] = ld_smem_u32(&s_q[(r0 + 8) * kPitch + c0 + 8]);
  }

  // Online-softmax state for this thread's two rows (r0 and r0 + 8).
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < kBlockK * (kD / 8); c += kThreads) {
      const int r = c >> 3;
      const int ch = c & 7;
      const int s = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (s < skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)s * row_stride + ch * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)s * row_stride + ch * 8);
      }
      *reinterpret_cast<uint4*>(&s_k[r * kPitch + ch * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) s_vt[(ch * 8 + i) * kPitch + r] = ve[i];
    }
    __syncthreads();

    // S = q k^T: 8 n-tiles of 8 keys, fp32 accumulators in the C layout.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const int key = j * 8 + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bf[2];
        const int d0 = ks * 16 + t * 2;
        bf[0] = ld_smem_u32(&s_k[key * kPitch + d0]);
        bf[1] = ld_smem_u32(&s_k[key * kPitch + d0 + 8]);
        mma_m16n8k16(sc[j], qf[ks], bf);
      }
    }

    if (k0 + kBlockK > skv) {  // ragged kv tail
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + j * 8 + t * 2 + (e & 1) >= skv) sc[j][e] = -INFINITY;
        }
      }
    }

    // m_new = max(m, rowmax(S)); rows are spread over the 4 threads of a group.
    float mx0 = m_run[0];
    float mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float alpha0 = exp2f(m_run[0] - mx0);
    const float alpha1 = exp2f(m_run[1] - mx1);
    float rs0 = 0.f;
    float rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mx0);
      sc[j][1] = exp2f(sc[j][1] - mx0);
      sc[j][2] = exp2f(sc[j][2] - mx1);
      sc[j][3] = exp2f(sc[j][3] - mx1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l_run[0] = l_run[0] * alpha0 + rs0;
    l_run[1] = l_run[1] * alpha1 + rs1;
    m_run[0] = mx0;
    m_run[1] = mx1;

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // acc += P v: P (rounded to bf16) is re-packed from the score fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int key0 = kk * 16 + t * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bf[2];
        const int dd = j * 8 + g;
        bf[0] = ld_smem_u32(&s_vt[dd * kPitch + key0]);
        bf[1] = ld_smem_u32(&s_vt[dd * kPitch + key0 + 8]);
        mma_m16n8k16(acc[j], pa, bf);
      }
    }
  }

  // O = acc / l in bf16; rows past sq are not stored.
  const int s_lo = q0 + r0;
  const int s_hi = s_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t * 2;
    if (s_lo < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)s_lo * row_stride + col) =
          pack_bf16x2(acc[j][0] / l_run[0], acc[j][1] / l_run[0]);
    }
    if (s_hi < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)s_hi * row_stride + col) =
          pack_bf16x2(acc[j][2] / l_run[1], acc[j][3] / l_run[1]);
    }
  }
  if (kWriteLse && t == 0) {  // one thread of each group holds the row's m and l
    float* lb = lse + (size_t)blockIdx.y * sq;  // [B, H, Sq]
    if (s_lo < sq) lb[s_lo] = m_run[0] + log2f(l_run[0]);
    if (s_hi < sq) lb[s_hi] = m_run[1] + log2f(l_run[1]);
  }
}

template <bool kWriteLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
                     int sq, int skv, float qscale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || (long long)batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_bf16_d64_kernel<kWriteLse><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), heads, sq,
      skv, qscale);
  return (int)cudaGetLastError();
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

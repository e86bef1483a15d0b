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
// What bounds it on the H100: operations. Hopper's tensor cores take fp32 only
// as TF32 (10 mantissa bits), which misses the fp32 tolerance of the plain
// version, so every product here is an FFMA on the CUDA cores: 132 SMs x 128
// lanes x 2 operations per clock, ~66.9 TFLOP/s at 1.98 GHz, against 989 for
// the bf16 wgmma kernels. At head_dim 64 a (q row, key) pair costs 128 (K1/K2),
// 192 (K3) or 256 (K4) FFMA for 2-4 bytes of shared-memory traffic per FFMA
// pair, far above the memory ridge.
//
// Design: a simple tiled SIMT kernel, the first right version.
//   * One CTA of 128 threads owns 64 rows (q rows for K1-K3, keys for K4) of
//     one (batch, head). Two neighbouring lanes share a row, each holding 32 of
//     its 64 columns in registers as 8 float4 chunks (chunk c of lane `half`
//     covers columns 8c + 4*half .. +3, so a pair reads two adjacent 16-byte
//     words of a shared-memory row: one broadcast, no bank conflict); a dot
//     product is each lane's 32 FFMA plus one __shfl_xor_sync, and both lanes
//     then hold the same sum, so the softmax state stays identical in the pair.
//   * The other operand streams through static shared memory in tiles of 32
//     rows (K and V for K1-K3; Q, dO, lse and D for K4), 16 KB a tile, loaded
//     by all threads as float4 and synchronised with __syncthreads; rows past
//     the sequence are zero-filled and masked out of the softmax (score -inf)
//     or the sums (p = 0, dS = 0).
//   * Rows past the end of a ragged last block compute on a copy of the last
//     row and store nothing.
//   * exp2f/log2f and the division acc / l are the accurate library forms, not
//     ex2.approx: the fp32 tolerance (relative L2 1e-5) leaves no room for them.
//
// Layout: q/o/dO [B, Sq, H, 64], k/v/dk/dv [B, Skv, H, 64], all fp32,
// contiguous and 16-byte aligned; lse and D fp32 [B, H, Sq].

#include <cuda_runtime.h>
#include <math.h>

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

__device__ __forceinline__ void store_row(float* row, const Row& r, int half, float mul) {
  float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    p[2 * c + half] = make_float4(r.c[c].x * mul, r.c[c].y * mul, r.c[c].z * mul, r.c[c].w * mul);
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

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                                                                     const float* __restrict__ k,
                                                                     const float* __restrict__ v,
                                                                     const float* __restrict__ d_o,
                                                                     const float* __restrict__ lse,
                                                                     const float* __restrict__ delta,
                                                                     float* __restrict__ dq, int heads, int sq,
                                                                     int skv, float qscale, float scale) {
  __shared__ float4 ks[kTile][kVec];
  __shared__ float4 vs[kTile][kVec];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 1);
  const int row_c = min(row, sq - 1);
  const long long stride = (long long)heads * kD;
  const float* kb = k + ((long long)b * skv * heads + h) * kD;
  const float* vb = v + ((long long)b * skv * heads + h) * kD;
  const long long q_off = ((long long)b * sq * heads + h) * kD + (long long)row_c * stride;

  Row q2, dor, acc;
  load_row(q2, q + q_off, half, qscale);
  load_row(dor, d_o + q_off, half, 1.f);
  zero_row(acc);
  const float lse_r = lse[(long long)bh * sq + row_c];
  const float d_r = delta[(long long)bh * sq + row_c];

  for (int j0 = 0; j0 < skv; j0 += kTile) {
    __syncthreads();
    load_tile(ks, kb, j0, skv, stride);
    load_tile(vs, vb, j0, skv, stride);
    __syncthreads();
    const int n = min(kTile, skv - j0);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float s = pair_dot(q2, ks, t, half);
      const float dp = pair_dot(dor, vs, t, half);
      const float ds = t < n ? exp2f(s - lse_r) * (dp - d_r) : 0.f;
      axpy(acc, ds, ks, t, half);
    }
  }
  if (row < sq) store_row(dq + q_off, acc, half, scale);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                                                                      const float* __restrict__ k,
                                                                      const float* __restrict__ v,
                                                                      const float* __restrict__ d_o,
                                                                      const float* __restrict__ lse,
                                                                      const float* __restrict__ delta,
                                                                      float* __restrict__ dk, float* __restrict__ dv,
                                                                      int heads, int sq, int skv, float qscale,
                                                                      float scale) {
  __shared__ float4 qs[kTile][kVec];
  __shared__ float4 dos[kTile][kVec];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int half = threadIdx.x & 1;
  const int key = blockIdx.x * kRows + (threadIdx.x >> 1);
  const long long stride = (long long)heads * kD;
  const float* qb = q + ((long long)b * sq * heads + h) * kD;
  const float* dob = d_o + ((long long)b * sq * heads + h) * kD;
  const long long k_off = ((long long)b * skv * heads + h) * kD + (long long)min(key, skv - 1) * stride;
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;

  Row k2, vr, dk_acc, dv_acc;
  load_row(k2, k + k_off, half, qscale);
  load_row(vr, v + k_off, half, 1.f);
  zero_row(dk_acc);
  zero_row(dv_acc);

  for (int i0 = 0; i0 < sq; i0 += kTile) {
    __syncthreads();
    load_tile(qs, qb, i0, sq, stride);
    load_tile(dos, dob, i0, sq, stride);
    if (threadIdx.x < kTile) {
      const bool in = i0 + threadIdx.x < sq;
      lse_s[threadIdx.x] = in ? lse_b[i0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = in ? delta_b[i0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, sq - i0);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float s = pair_dot(k2, qs, t, half);
      const float p = t < n ? exp2f(s - lse_s[t]) : 0.f;
      axpy(dv_acc, p, dos, t, half);
      const float dp = pair_dot(vr, dos, t, half);
      axpy(dk_acc, p * (dp - delta_s[t]), qs, t, half);
    }
  }
  if (key >= skv) return;
  store_row(dk + k_off, dk_acc, half, scale);
  store_row(dv + k_off, dv_acc, half, 1.f);
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
  flash_bwd_dq_f32_kernel<<<grid_of(batch, heads, sq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), heads, sq, skv, qscale, scale);
  return (int)cudaGetLastError();
}

extern "C" int instantir_flash_bwd_dkv_f32_d64(const void* q, const void* k, const void* v, const void* d_o,
                                               const void* lse, const void* delta, void* dk, void* dv, int batch,
                                               int heads, int sq, int skv, float qscale, float scale, void* stream) {
  if (bad_shape(batch, heads, sq, skv)) return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_f32_kernel<<<grid_of(batch, heads, skv), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, skv, qscale, scale);
  return (int)cudaGetLastError();
}

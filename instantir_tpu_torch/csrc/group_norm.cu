// GroupNorm(+SiLU) for Hopper (sm_90a): one thread-block cluster per (batch, group).
//
// Replaces the TPU kernel instantir_tpu/ops/group_norm.py::group_norm_silu_pallas
// (_gn_stats_kernel, then _gn_norm_kernel, with the [B, C] group arithmetic in
// XLA between them): GroupNorm over NCHW x with fp32 statistics in the
// E[x^2] - mu^2 form, the variance clamped at 0; y = x*w + b with
// w = rstd*gamma_c and b = beta_c - mu*w; an optional SiLU; y in x's dtype
// (bf16, fp16 or fp32). gamma and beta are fp32.
//
// What bounds it on the H100: bytes. A handful of operations per element
// against x read once and y written once: 0.0375 ms at 3.35 TB/s for the
// largest call of the 1024^2 restore (B=2, 960x128^2, bf16: x is 62.9 MB). The
// Triton pair this kernel replaced read x twice (statistics, then normalise;
// at that shape x does not fit in the 50 MB L2, so the second read came from
// HBM: at most 2/3 of the bound) and paid two launches through Triton's
// Python launcher, which took longer on the host than the device took to run
// them at most shapes.
//
// Design: one launch, x read once, y written once.
//   * The grid is B*G clusters of cs CTAs (cs = 1, 2, 4, 8 or 16, chosen on the
//     host by ops/group_norm.py::gn_plan; 16 is a non-portable cluster size,
//     allowed per kernel and checked with cudaOccupancyMaxActiveClusters).
//     A (batch, group) slab of cpg*H*W elements is contiguous in NCHW. Its
//     16-byte-aligned body is cut into cs near-equal runs of 16-byte vectors,
//     one per CTA; the elements before the first 16-byte boundary (the head,
//     rank 0) and after the last (the tail, rank cs-1) go one at a time. A
//     slab starts off 16-byte alignment when cpg*H*W*itemsize % 16 != 0
//     (320x45^2 bf16: 40,500 B a group). ops/group_norm.py::slab_slices states
//     the same partition in Python.
//   * A CTA brings up to res_vec vectors of its run into dynamic shared memory
//     by 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx), in kChunks
//     chunks with one mbarrier each, and sums x and x^2 in fp32 as the chunks
//     land: per thread, warp shuffles, the CTA's warps in order.
//   * Each CTA leaves its (sum, sum of squares) in its shared memory; after
//     barrier.cluster every CTA reads all cs of them through distributed
//     shared memory (mapa + ld.shared::cluster) and adds them in rank order,
//     so every CTA, and every run, gets the same statistics: no atomics and
//     no scratch in device memory.
//   * It folds mean, clamped variance and rstd into w and b for the cpg
//     channels of its group (a table in shared memory), normalises its run
//     from the shared-memory copy and writes y with 16-byte stores.
//   * A second cluster barrier, arrived at once the peers' partials are read
//     and waited for before exit, keeps a CTA's shared memory alive while its
//     peers may still read it.
//   * A run longer than res_vec (a slab larger than the cluster's shared
//     memory: fp32 at 128^2, bf16 past 1024^2 images) is handled in the same
//     kernel: the rest of the run is read from global memory for the sums
//     while the bulk copies land, and read again to normalise.
//   * The host keeps each CTA's shared memory at most a third of an SM's, so
//     three or more CTAs share an SM and one's loads and sums overlap
//     another's normalising and stores. Where the whole tensor fits in the
//     card's shared memory (x <= ~30 MB) the launch is one wave: all CTAs
//     load, then all store.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;  // bulk copies, each on its own mbarrier, per CTA
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
// what ops/group_norm.py::gn_plan allows for this kernel's __shared__ variables
constexpr int kStaticSmemBound = 256;

// ---- element types: one value or a 16-byte vector <-> fp32 ----

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  static __device__ void unpack(const uint4& u, float (&f)[kVec]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ uint4 pack(const float (&f)[kVec]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Elem<__half> {
  static constexpr int kVec = 8;
  static __device__ float load(const __half* p) { return __half2float(*p); }
  static __device__ void store(__half* p, float v) { *p = __float2half_rn(v); }
  static __device__ void unpack(const uint4& u, float (&f)[kVec]) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ uint4 pack(const float (&f)[kVec]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ float load(const float* p) { return *p; }
  static __device__ void store(float* p, float v) { *p = v; }
  static __device__ void unpack(const uint4& u, float (&f)[kVec]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// ---- PTX: clusters, mbarriers, bulk copies ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
// Two fp32 at `local_addr` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float2 ld_peer_f32x2(uint32_t local_addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local_addr), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// 1-D bulk copy global -> this CTA's shared memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int V>
__device__ __forceinline__ void add_vec(const float (&f)[V], float& s, float& q) {
  float ps = 0.f, pq = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ps += f[j];
    pq = fmaf(f[j], f[j], pq);
  }
  s += ps;
  q += pq;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// SiLU of each value, v * sigmoid(v), with 1.5 special-function operations a
// value (the SFU's 16 a clock per SM would otherwise cap the store phase):
// a pair shares one reciprocal, 1/((1+e^-a)(1+e^-b)). The exponent is capped
// at 2^60 so that the product stays finite; sigmoid below 2^-60 is 0 to fp32.
template <int V>
__device__ __forceinline__ void silu(float (&f)[V]) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int j = 0; j < V; j += 2) {
    const float da = 1.0f + ex2(fminf(-f[j] * kLog2e, 60.0f));
    const float db = 1.0f + ex2(fminf(-f[j + 1] * kLog2e, 60.0f));
    const float r = rcp(da * db);
    f[j] *= db * r;
    f[j + 1] *= da * r;
  }
}

template <bool kSilu>
__device__ __forceinline__ float activate(float v) {
  if (!kSilu) return v;
  float f[2] = {v, 0.0f};
  silu(f);
  return f[0];
}

struct GnArgs {
  int n;        // elements of one (batch, group) slab: cpg * hw
  int hw;       // elements of one channel
  int cpg;      // channels per group
  int groups;   // G
  int res_vec;  // 16-byte vectors a CTA keeps in shared memory
  float eps;
};

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    group_norm_silu_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                           const float* __restrict__ beta, GnArgs a) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ float2 warp_part[kWarps];
  __shared__ float2 partial;  // this CTA's (sum, sum of squares): its peers read it
  __shared__ float2 gathered[kMaxCluster];

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_ctarank(), cs = cluster_nctarank();
  const long long bg = cluster_id_x();  // = b*G + g
  const int g = (int)(bg % a.groups);

  // This CTA's run of the slab.
  const T* xs = x + bg * a.n;
  T* ys = y + bg * a.n;
  const int mis = (int)(reinterpret_cast<uintptr_t>(xs) & 15);  // y shares x's alignment (checked on the host)
  const int head = min(mis ? (16 - mis) / (int)sizeof(T) : 0, a.n);
  const long long nvec = (a.n - head) / V;
  const int tail0 = head + (int)(nvec * V);
  const long long v0 = nvec * rank / cs, v1 = nvec * (rank + 1) / cs;
  const int len = (int)(v1 - v0);
  const int res = min(len, a.res_vec);
  const uint4* xv = reinterpret_cast<const uint4*>(xs + head) + v0;
  uint4* yv = reinterpret_cast<uint4*>(ys + head) + v0;
  const uint4* sv = reinterpret_cast<const uint4*>(smem);
  float* wt = reinterpret_cast<float*>(smem + (size_t)a.res_vec * 16);  // per-channel w, then b
  float* bt = wt + a.cpg;

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) mbar_init(smem_u32(&bars[k]), 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c0 = res * k / kChunks, c1 = res * (k + 1) / kChunks;
      const uint32_t bytes = (uint32_t)(c1 - c0) * 16u;
      mbar_expect_tx(smem_u32(&bars[k]), bytes);
      if (bytes) bulk_copy_g2s(smem_u32(sv + c0), xv + c0, bytes, smem_u32(&bars[k]));
    }
  }
  float gam = 0.f, bet = 0.f;  // fetched now, used after the cluster barrier
  if (tid < a.cpg) {
    gam = gamma[g * a.cpg + tid];
    bet = beta[g * a.cpg + tid];
  }

  // fp32 sums of x and x^2: first what is not copied (the rest of a long run,
  // the head, the tail), from global memory while the copies land
  float s = 0.f, q = 0.f;
#pragma unroll 4
  for (int i = res + tid; i < len; i += kThreads) {
    float f[V];
    E::unpack(__ldg(xv + i), f);
    add_vec(f, s, q);
  }
  if (rank == 0) {
    for (int i = tid; i < head; i += kThreads) {
      const float v = E::load(xs + i);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  if (rank == cs - 1) {
    for (int i = tail0 + tid; i < a.n; i += kThreads) {
      const float v = E::load(xs + i);
      s += v;
      q = fmaf(v, v, q);
    }
  }
#pragma unroll 1
  for (int k = 0; k < kChunks; ++k) {
    const int c0 = res * k / kChunks, c1 = res * (k + 1) / kChunks;
    mbar_wait(smem_u32(&bars[k]), 0);
#pragma unroll 4
    for (int i = c0 + tid; i < c1; i += kThreads) {
      float f[V];
      E::unpack(sv[i], f);
      add_vec(f, s, q);
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if ((tid & 31) == 0) warp_part[tid >> 5] = make_float2(s, q);
  __syncthreads();
  if (tid == 0) {
    float2 p = warp_part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      p.x += warp_part[w].x;
      p.y += warp_part[w].y;
    }
    partial = p;
  }

  // the cluster's statistics, added in rank order
  cluster_arrive();
  cluster_wait();
  if (tid < (int)cs) gathered[tid] = ld_peer_f32x2(smem_u32(&partial), tid);
  cluster_arrive();  // this CTA's reads of its peers are done; waited for before exit
  __syncthreads();
  float ts = 0.f, tq = 0.f;
  for (uint32_t r = 0; r < cs; ++r) {
    ts += gathered[r].x;
    tq += gathered[r].y;
  }
  const float nf = (float)a.n;
  const float mean = ts / nf;
  const float var = fmaxf(__fsub_rn(tq / nf, __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + a.eps);
  if (tid < a.cpg) {
    const float w = rstd * gam;
    wt[tid] = w;
    bt[tid] = bet - mean * w;
  }
  for (int j = tid + kThreads; j < a.cpg; j += kThreads) {
    const float w = rstd * gamma[g * a.cpg + j];
    wt[j] = w;
    bt[j] = beta[g * a.cpg + j] - mean * w;
  }
  __syncthreads();

  // y = x*w + b (+SiLU), w and b of each element's channel. A thread's vectors
  // lie kThreads*V elements apart, so its (channel, offset) advances by a
  // constant step: one division per thread, not one per vector.
  const uint32_t hw = (uint32_t)a.hw;
  const uint32_t step_c = (uint32_t)(kThreads * V) / hw, step_r = (uint32_t)(kThreads * V) - step_c * hw;
  auto normalise = [&](float (&f)[V], uint32_t c, uint32_t r) {
    if (r + V <= hw) {  // the vector lies in one channel
      const float w = wt[c], b = bt[c];
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = fmaf(f[j], w, b);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        while (r >= hw) {
          r -= hw;
          ++c;
        }
        f[j] = fmaf(f[j], wt[c], bt[c]);
        ++r;
      }
    }
    if (kSilu) silu(f);
  };
  const uint32_t e_run = (uint32_t)head + (uint32_t)v0 * V;  // slab index of the run's first element
  uint32_t ch = (e_run + (uint32_t)tid * V) / hw, off = (e_run + (uint32_t)tid * V) - ch * hw;
#pragma unroll 4
  for (int i = tid; i < res; i += kThreads) {
    float f[V];
    E::unpack(sv[i], f);
    normalise(f, ch, off);
    yv[i] = E::pack(f);
    ch += step_c;
    off += step_r;
    if (off >= hw) {
      off -= hw;
      ++ch;
    }
  }
  const uint32_t e_rest = e_run + (uint32_t)(res + tid) * V;
  ch = e_rest / hw;
  off = e_rest - ch * hw;
#pragma unroll 4
  for (int i = res + tid; i < len; i += kThreads) {
    float f[V];
    E::unpack(__ldg(xv + i), f);
    normalise(f, ch, off);
    yv[i] = E::pack(f);
    ch += step_c;
    off += step_r;
    if (off >= hw) {
      off -= hw;
      ++ch;
    }
  }
  if (rank == 0) {
    for (int i = tid; i < head; i += kThreads) {
      const int c = i / a.hw;
      E::store(ys + i, activate<kSilu>(fmaf(E::load(xs + i), wt[c], bt[c])));
    }
  }
  if (rank == cs - 1) {
    for (int i = tail0 + tid; i < a.n; i += kThreads) {
      const int c = i / a.hw;
      E::store(ys + i, activate<kSilu>(fmaf(E::load(xs + i), wt[c], bt[c])));
    }
  }
  cluster_wait();  // every peer has read this CTA's partial: its shared memory may go
}

template <typename T, bool kSilu>
int launch_typed(const void* x, void* y, const void* gamma, const void* beta, int batch_groups, int cs,
                 bool non_portable, int smem_bytes, const GnArgs& a, cudaStream_t stream) {
  auto kernel = group_norm_silu_kernel<T, kSilu>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool configured[kMaxDevices] = {};
  static bool non_portable_allowed[kMaxDevices] = {};
  static int fits[kMaxDevices][5] = {};  // per log2(cs): 1 + the most dynamic shared memory known to fit
  if (!configured[device]) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    if (fa.sharedSizeBytes > (size_t)kStaticSmemBound) return (int)cudaErrorInvalidConfiguration;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  if (non_portable && !non_portable_allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable_allowed[device] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch_groups * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int lg = 0;
  while ((1 << lg) < cs) ++lg;
  if (smem_bytes >= fits[device][lg]) {  // not yet known to fit: ask once per (cluster size, larger smem)
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    fits[device][lg] = smem_bytes + 1;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                                 static_cast<const float*>(gamma), static_cast<const float*>(beta), a);
}

template <typename T>
int launch_dtype(bool silu, const void* x, void* y, const void* gamma, const void* beta, int batch_groups, int cs,
                 bool non_portable, int smem_bytes, const GnArgs& a, cudaStream_t stream) {
  return silu ? launch_typed<T, true>(x, y, gamma, beta, batch_groups, cs, non_portable, smem_bytes, a, stream)
              : launch_typed<T, false>(x, y, gamma, beta, batch_groups, cs, non_portable, smem_bytes, a, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 bf16, 1 fp16, 2 fp32. The
// launch plan (cs, non_portable, res_vec, smem_bytes) comes from
// ops/group_norm.py::gn_plan. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int instantir_group_norm_silu(const void* x, void* y, const void* gamma, const void* beta, int dtype,
                                         int batch_groups, int groups, int n, int hw, int cpg, int cs,
                                         int non_portable, int res_vec, int smem_bytes, int apply_silu, float eps,
                                         void* stream) {
  if (batch_groups <= 0 || groups <= 0 || batch_groups % groups != 0 || hw <= 0 || cpg <= 0 ||
      (long long)cpg * hw != (long long)n || res_vec < 0 || smem_bytes < res_vec * 16 + 8 * cpg)
    return (int)cudaErrorInvalidValue;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 || (cs > 8) != (non_portable != 0) ||
      (long long)batch_groups * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const GnArgs a{n, hw, cpg, groups, res_vec, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool silu = apply_silu != 0, np = non_portable != 0;
  switch (dtype) {
    case 0:
      return launch_dtype<__nv_bfloat16>(silu, x, y, gamma, beta, batch_groups, cs, np, smem_bytes, a, s);
    case 1:
      return launch_dtype<__half>(silu, x, y, gamma, beta, batch_groups, cs, np, smem_bytes, a, s);
    case 2:
      return launch_dtype<float>(silu, x, y, gamma, beta, batch_groups, cs, np, smem_bytes, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// PTX wrappers for the Hopper (sm_90a) kernels of flash_fwd.cu, flash_bwd.cu
// and flash_f32.cu: shared-memory addresses, bf16 packing, exp2, cp.async
// copies and the proxy fence, the wgmma fence / commit / wait and register
// fences, the 128-byte swizzle descriptor, the two bf16 wgmma m64n64k16 forms
// the bf16 sources use and the two tf32 forms of the fp32 forward (m64n32k8
// and m64n64k8, A from registers); and the host checks their entry points
// share (shape, shared-memory opt-in).
//
// Tile layout every descriptor here assumes: rows of 128 bytes (64 bf16 or 32
// fp32), 16-byte chunk c of row r at chunk c ^ (r % 8), 1024 bytes between
// 8-row groups, the tile's base aligned to 1024 bytes. A wgmma step reads 32
// bytes of each row (k16 in bf16, k8 in tf32): its descriptor's start moves by
// 32 bytes a step. tf32 operands are K-major only (no transpose flag).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// 4-byte asynchronous copy, for fp32 rows whose start is only 4-byte aligned.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Orders shared-memory writes of the generic proxy before reads of the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving uses of registers that a wgmma in flight writes or reads.
template <int kN>
__device__ __forceinline__ void reg_fence(float (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address, leading byte offset 1 (unused: one swizzle atom
// wide), 1024 bytes between 8-row groups, layout type B128.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define ACC32(d)                                                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),      \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),       \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ACC32_REGS                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 fp32) = a (64x16, shared, K-major) * b (16x64, shared, K-major: [n][k]) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64x64 fp32) += a (64x16, registers) * b (16x64, shared, MN-major: [k][n], the transpose flag set)
__device__ __forceinline__ void wgmma_m64n64k16_rs_bt(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                      uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

#define ACC16(d)                                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define ACC16_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64x32 fp32) = a (64x8 tf32, registers, as below) * b (8x32 tf32, shared, K-major: [n][k]) + (scale_d ? d : 0).
// The tensor cores read the top 19 bits of each fp32 word (the low 13 are ignored).
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " ACC16_REGS ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64x64 fp32) = a (64x8 tf32, registers: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each
// warp's 16 rows) * b (8x64 tf32, shared, K-major: [n][k]) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACC32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Shapes every entry point refuses (ops/attention.py raises on the same): an
// empty dimension, or batch * heads above 65535.
__host__ bool bad_shape(int batch, int heads, int sq, int skv) {
  return batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || (long long)batch * heads > 65535;
}

// Dynamic shared memory above 48 KB is opt-in, per kernel and device;
// `configured` is the kernel's own per-device record.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes, bool (&configured)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured[device] = true;
  return err;
}

}  // namespace

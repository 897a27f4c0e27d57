// Helpers shared by the kernels: element conversion, 16-byte vector loads
// and cp.async global -> shared copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;   // mask value of the reference kernels

// dtype codes of the C interface (the Python wrappers pass them)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Elements of T in one 16-byte vector load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// Load a 16-byte vector of T at `src` (16-byte aligned) as n floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < Vec<T>::n; ++u) dst[u] = to_float(e[u]);
}

// ---- cp.async: global -> shared copies that bypass the registers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from `src` to the shared address `dst`; with `valid` false
// nothing is read and the 16 bytes are zero-filled (`src` must still be a
// legal address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  cp_async16(smem_addr(dst), src, valid);
}

// Copy 4 bytes from `src` to shared `dst` (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace repro_torch

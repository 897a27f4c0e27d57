// Helpers shared by the attention kernels: element conversion and a
// vectorised global -> shared tile copy.
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

}  // namespace repro_torch

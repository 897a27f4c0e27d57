// One-token GQA decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_decode_bkhd` (`_decode_kernel`) of
// src/repro/kernels/flash_decode.py: q (B,KV,G,hd) attends to k/v
// (B,KV,C,hd) with an additive fp32 validity bias (B,C); online softmax
// with fp32 (m, l, acc); scores are scaled by 1/sqrt(hd), then soft-capped
// (tanh, when softcap > 0), then biased; l is floored at 1e-30.
//
// What bounds it on this card: bytes. Each call reads the whole K and V of
// its rows once (4.7 MB at the serve path's B=8, KV=4, C=576, hd=64 in
// bf16) for ~2 flops per byte, far below the ~295 flop/byte at which the
// tensor cores become the limit; the bound is K+V over 3.35 TB/s (~1.4 us).
//
// What the design does about it: one CTA per (b, kv-head) keeps the G
// query rows of the group resident in shared memory, so K and V are read
// from device memory exactly once for all G heads that share them (the
// GQA saving), with 16-byte vector loads. The ragged tail (C % 64) and the
// validity bias are masked inside the kernel: unlike the TPU wrapper,
// nothing pads or copies the cache. Known shortfall: B*KV CTAs (32 at the
// serve shapes) underfill the 132 SMs and each CTA loads, then computes,
// with no overlap, so the kernel is latency-bound well above its bound;
// splitting C across CTAs (split-K with a combine pass) and double-buffered
// cp.async/TMA loads are the next steps.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;       // cache positions per shared-memory tile
constexpr int kMaxAcc = 32;   // accumulators per thread: G*hd <= 4096

// Copy `rows` contiguous rows of hd elements into fp32 shared memory with
// row stride `ld` (hd % Vec<T>::n == 0, so no vector straddles two rows).
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int rows, int hd,
                          float* dst, int ld) {
  constexpr int V = Vec<T>::n;
  const int n = rows * hd;
  for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
    float e[V];
    load_vec(src + i, e);
    const int r = i / hd, c = i % hd;
#pragma unroll
    for (int u = 0; u < V; ++u) dst[r * ld + c + u] = e[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    T* __restrict__ out, int KV, int G, int C, int hd,
                    float scale, float softcap) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;                 // padded: conflict-free score loop
  float* qs = smem;                       // (G, hd)
  float* ks = qs + G * hd;                // (kBK, hd+1)
  float* vs = ks + kBK * ldk;             // (kBK, hd)
  float* ps = vs + kBK * hd;              // (G, kBK) scores, then probs
  float* m_s = ps + G * kBK;              // (G,) running max
  float* l_s = m_s + G;                   // (G,) running sum
  float* a_s = l_s + G;                   // (G,) this tile's rescale

  const int bh = blockIdx.x;              // b * KV + kv-head
  const int b = bh / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int GH = G * hd;
  const T* kp = k + (size_t)bh * C * hd;
  const T* vp = v + (size_t)bh * C * hd;
  const float* bp = bias + (size_t)b * C;

  load_rows(q + (size_t)bh * GH, G, hd, qs, hd);
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < C; j0 += kBK) {
    const int rows = min(kBK, C - j0);
    __syncthreads();                      // previous tile fully consumed
    load_rows(kp + (size_t)j0 * hd, rows, hd, ks, ldk);
    load_rows(vp + (size_t)j0 * hd, rows, hd, vs, hd);
    __syncthreads();
    // scores for every (g, j) of the tile: x 1/sqrt(hd), softcap, + bias
    for (int e = tid; e < G * kBK; e += blockDim.x) {
      const int g = e / kBK, j = e % kBK;
      float s = kNegInf;                  // ragged tail: masked in-kernel
      if (j < rows) {
        const float* qr = qs + g * hd;
        const float* kr = ks + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s += bp[j0 + j];
      }
      ps[e] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row of the group
    for (int g = warp; g < G; g += nwarps) {
      float* pr = ps + g * kBK;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = j < rows ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc(g, d) = acc * alpha(g) + sum_j p(g, j) v(j, d)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < GH) {
        const int g = e / hd, d = e % hd;
        const float* pr = ps + g * kBK;
        float pv = 0.f;
        for (int j = 0; j < rows; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
        acc[i] = acc[i] * a_s[g] + pv;
      }
    }
  }
  __syncthreads();
  T* op = out + (size_t)bh * GH;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < GH) store(op + e, acc[i] / fmaxf(l_s[e / hd], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int KV, int G, int C,
                   int hd, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
       (size_t)G * kBK + 3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), KV, G, C, hd,
      1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   void* out, int B, int KV, int G, int C,
                                   int hd, float softcap, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (G * hd > kThreads * kMaxAcc || hd % 8 != 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const float*>(bias);
  if (dtype == kFloat32)
    return (int)launch<float>(q, k, v, bp, out, B, KV, G, C, hd, softcap, s);
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16>(q, k, v, bp, out, B, KV, G, C, hd,
                                      softcap, s);
  return (int)cudaErrorInvalidValue;
}

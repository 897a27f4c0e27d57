// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_bkhd` (`_prefill_kernel`) of
// src/repro/kernels/flash_prefill.py: causal attention with an optional
// sliding window (window > 0: key j is visible to query i iff
// i - window < j <= i) and optional tanh softcap; scores are scaled by
// 1/sqrt(hd) then soft-capped; masked scores are -1e30; fp32 online
// softmax and accumulation; l floored at 1e-30.
//
// It takes the model layout directly: q (B,S,H,hd), k/v (B,S,KV,hd) ->
// out (B,S,H,hd). The TPU wrapper's (B,KV,G,S,hd) relayout and the
// padding of S to a block multiple are gone: the kernel computes its
// offsets from the strides and masks the ragged S edge itself.
//
// What bounds it on this card: bytes, at the serve path's shapes
// (B=8, S=512, H=32, KV=4, hd=64, bf16): reading q, k, v and writing out
// is ~37.7 MB (~11.3 us at 3.35 TB/s) against ~8.6 GFLOP of causal
// products (~8.7 us on the bf16 tensor cores).
//
// What the design does about it: one CTA per (b, head, 64-query tile)
// walks 64-key tiles only from the window start to the causal frontier
// (tiles the mask would zero are never loaded), keeps Q, the K/V tile and
// the probabilities in shared memory and the 64 x hd output accumulator in
// registers (4 rows x hd/8 columns per thread), so each q/k/v element is
// read from device memory once per tile pass and the score matrix never
// leaves the SM. The products run on the fp32 CUDA cores (register-tiled
// 4x8 micro-tiles), so at these shapes the kernel is bound by fp32 issue
// rate rather than by bytes; mma/wgmma on the tensor cores for the bf16
// path, and sharing K/V tiles across the G heads of a group, are the next
// steps.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per tile

// Shared layout (floats): Qt (HD, BQ) | Kt (HD, BK) | Vs (BK, HD) | Pt (BK, BQ)
template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * kBQ + (size_t)HD * kBK + (size_t)kBK * HD +
         (size_t)kBK * kBQ;
}

// Copy rows [r0, r0+n) of a (rows, HD) slab with row stride `stride`
// (elements) into shared memory, transposed (dst[d * ld + r]) or not
// (dst[r * ld + d]); rows at or past `limit` are zero-filled.
template <typename T, int HD, bool kTranspose>
__device__ void load_tile(const T* __restrict__ base, size_t stride, int r0,
                          int n, int limit, float* dst, int ld) {
  constexpr int V = Vec<T>::n;
  constexpr int per_row = HD / V;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    float e[V];
    if (r0 + r < limit) {
      load_vec(base + (size_t)(r0 + r) * stride + c, e);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) e[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (kTranspose) dst[(c + u) * ld + r] = e[u];
      else dst[r * ld + c + u] = e[u];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int H, int KV, int window, float scale, float softcap) {
  constexpr int NC = HD / 32;            // 4-wide output column chunks
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                      // (HD, BQ)
  float* Kt = Qt + HD * kBQ;             // (HD, BK)
  float* Vs = Kt + HD * kBK;             // (BK, HD)
  float* Pt = Vs + kBK * HD;             // (BK, BQ)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;  // rows rg*4..+3; cols cg*4+{0..3}, +32
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  load_tile<T, HD, true>(qb, q_stride, q0, kBQ, S, Qt, kBQ);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  // Tiles the causal/window mask leaves any query of this CTA: skip the rest.
  const int n_tiles = (S + kBK - 1) / kBK;
  const int kt_end = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // previous tile fully consumed
    load_tile<T, HD, true>(kb, kv_stride, k0, kBK, S, Kt, kBK);
    load_tile<T, HD, false>(vb, kv_stride, k0, kBK, S, Vs, HD);
    __syncthreads();

    // S micro-tile: rows rg*4+i, columns cg*4+u and 32+cg*4+u
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + rg * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * kBK + cg * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Kt + d * kBK + 32 + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // scale, softcap, mask; online softmax across the 8 lanes of a row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = kj <= qi && kj < S && (window <= 0 || kj > qi - window);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4;
      *reinterpret_cast<float4*>(Pt + col * kBQ + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc(rows, cols) += P(rows, :) V(:, cols); cols = c*32 + cg*4 + u
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * kBQ + rg * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * HD + c * 32 + cg * 4);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][c * 4 + u] = fmaf(pv[i], vf[u], acc[i][c * 4 + u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (size_t)b * S * q_stride + (size_t)qi * q_stride +
              (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        store(orow + c * 32 + cg * 4 + u, acc[i][c * 4 + u] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, window,
      1.0f / sqrtf((float)HD), softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KV, int hd,
                        int window, float softcap, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, B, S, H, KV, window, softcap, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, B, S, H, KV, window, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int KV, int hd, int window,
                                    float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  if (S <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)dispatch_hd<float>(q, k, v, out, B, S, H, KV, hd, window,
                                   softcap, s);
  if (dtype == kBFloat16)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd,
                                           window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_chunked` (`_ssd_kernel`) of
// src/repro/kernels/ssd_scan.py. For each (batch row, head), over chunks
// of q steps, in fp32 inside:
//   xdt = x * dt, dA = dt * A, cs = inclusive cumsum of dA in the chunk;
//   y[l]  = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) xdt_s      (diagonal)
//         + exp(cs_l) (C_l . state)                           (carried)
//   state <- exp(cs_last) state + sum_s exp(cs_last - cs_s) B_s (x) xdt_s
// y is written in x's dtype, the final state in fp32. B and C are shared by
// all heads (ngroups = 1).
//
// Layouts: x (b,s,h,p) and B, C (b,s,n) are read through their batch and
// step strides (each (batch, step) row packed), so the model passes views
// of its conv output, and a caller any slice along s, without copies;
// dt (b,s,h), A (h,), the initial state (b,h,p,n; null = zeros) and both
// outputs are packed. The TPU kernel needs s % q == 0 and the model pads;
// here a ragged last chunk is masked in-kernel (its missing steps load as
// dt = 0, x = B = C = 0, which leave the state unchanged, and their y is
// not written).
//
// What bounds it on this card: bytes. At the serve path's shape (mamba2-130m,
// b=8, s=512, h=24, p=64, n=128, q=128, bf16 x/B/C/y, fp32 dt and states)
// one call moves ~40 MB (~12 us at 3.35 TB/s) against ~5 GFLOP of
// contractions (~5 us on the bf16 tensor cores).
//
// What the design does about it: the TPU's sequential chunk grid axis with
// its VMEM scratch state becomes a loop inside one CTA per (batch row,
// head), with the (p, n) fp32 state resident in shared memory for the
// whole sequence, so x, B, C and dt are read from device memory once and
// the state is read and written once. A chunk's xdt, B and C stay in
// shared memory in fp32 (rows padded to n+1 floats: conflict-free column
// reads); the (q x q) decayed C.B matrix is built 32 output rows at a time
// (32 x q floats), which keeps one CTA under the 227 KB limit at
// p=64, n=128, q=128 (~211 KB). The three contractions run on the fp32 CUDA
// cores with register micro-tiles, so the kernel is bound by instruction and
// shared-memory bandwidth, far above its byte bound. Known shortfalls:
// b*h CTAs (192 at the serve shape) fill 132 SMs in 1.45 waves at one CTA
// per SM; C.B is recomputed by every head of a row. Tensor-core mma/wgmma,
// TMA loads, and one C.B per (batch row, chunk) shared by all heads are the
// next steps.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQMax = 128;      // largest chunk (the warp cumsum owns 4 rows/lane)
constexpr int kTR = 32;         // output rows per tile: 8 warps x 4 rows
constexpr size_t kMaxSmem = 232448;

// Dynamic shared memory in floats (the wrapper's `smem_bytes` mirrors it).
__host__ __device__ constexpr size_t smem_floats(int P, int N, int q) {
  return (size_t)q * P + 2 * (size_t)q * (N + 1) + (size_t)P * (N + 1) +
         (size_t)kTR * q + 3 * (size_t)q;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, int S, int H,
                int q, long long x_bs, long long x_row, long long bc_bs,
                long long bc_row) {
  constexpr int LDN = N + 1;            // padded row of B, C and the state
  constexpr int PJ = P / 32;            // output columns per thread
  // state-update mapping: lanes along n, warps (and lane halves) along p
  constexpr int KL = N < 32 ? N : 32;
  constexpr int RPW = 32 / KL;
  constexpr int KJ = N / KL;
  constexpr int PI = P / (kWarps * RPW);
  static_assert(P % 32 == 0 && N % KL == 0 && P % (kWarps * RPW) == 0,
                "unsupported (p, n)");

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // (q, P)   x * dt
  float* Bs = xs + q * P;                        // (q, LDN)
  float* Cs = Bs + q * LDN;                      // (q, LDN)
  float* st = Cs + q * LDN;                      // (P, LDN) carried state
  float* Mt = st + P * LDN;                      // (kTR, q) decayed C.B tile
  float* cs = Mt + kTR * q;                      // (q,) cumsum of dt * A
  float* wv = cs + q;                            // (q,) exp(cs_last - cs_s)
  float* dts = wv + q;                           // (q,) dt

  const int hh = blockIdx.x % H;
  const int bi = blockIdx.x / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float a = A[hh];
  const size_t st_off = ((size_t)bi * H + hh) * P * N;

  for (int e = tid; e < P * N; e += kThreads)
    st[(e / N) * LDN + e % N] = init ? init[st_off + e] : 0.f;

  const int n_chunks = (S + q - 1) / q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * q;
    const int qv = min(q, S - t0);      // steps of this chunk inside s
    const size_t row0 = (size_t)bi * S + t0;   // packed dt and y rows
    const T* xb = x + bi * x_bs + t0 * x_row + (long long)hh * P;
    const long long bc0 = bi * bc_bs + t0 * bc_row;
    __syncthreads();                    // state ready; last chunk consumed
    for (int l = tid; l < q; l += kThreads)
      dts[l] = l < qv ? dt[(row0 + l) * H + hh] : 0.f;
    for (int e = tid; e < q * N; e += kThreads) {
      const int l = e / N, k = e % N;
      float bv = 0.f, cv = 0.f;
      if (l < qv) {
        const long long off = bc0 + l * bc_row + k;
        bv = to_float(Bm[off]);
        cv = to_float(Cm[off]);
      }
      Bs[l * LDN + k] = bv;
      Cs[l * LDN + k] = cv;
    }
    __syncthreads();
    for (int e = tid; e < q * P; e += kThreads) {
      const int l = e / P, pi = e % P;
      xs[e] = l < qv ? to_float(xb[l * x_row + pi]) * dts[l] : 0.f;
    }
    if (warp == 0) {                    // inclusive cumsum, 4 rows per lane
      float v[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lane * 4 + u;
        run += l < q ? dts[l] * a : 0.f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lane * 4 + u;
        if (l < q) {
          cs[l] = excl + v[u];
          wv[l] = expf(total - (excl + v[u]));
        }
      }
    }
    __syncthreads();

    // ---- outputs, 32 rows at a time (uses the state BEFORE this chunk)
    const int r0 = warp * 4;            // this warp's 4 rows of the tile
    for (int l0 = 0; l0 < qv; l0 += kTR) {
      const int ncol = min(qv, l0 + kTR);   // causal: columns s < ncol
      const int jmax = (ncol + 31) / 32;
      {   // Mt[r][s] = (C_l . B_s) exp(cs_l - cs_s) for s <= l, else 0
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        int lr[4], sc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) lr[i] = min(l0 + r0 + i, q - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[j] = min(lane + 32 * j, q - 1);
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[lr[i] * LDN + k];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = j < jmax ? Bs[sc[j] * LDN + k] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + r0 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = lane + 32 * j;
            if (s < ncol)
              Mt[(r0 + i) * q + s] =
                  (l < qv && s <= l) ? acc[i][j] * expf(cs[l] - cs[s]) : 0.f;
          }
        }
      }
      __syncthreads();
      {   // y = Mt . xdt + exp(cs_l) (C_l . state)
        float acc[4][PJ], off[4][PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = off[i][j] = 0.f;
        for (int s = 0; s < ncol; ++s) {
          float m[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = Mt[(r0 + i) * q + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(m[i], xv[j], acc[i][j]);
        }
        int lr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) lr[i] = min(l0 + r0 + i, q - 1);
        for (int k = 0; k < N; ++k) {
          float cv[4], sv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[lr[i] * LDN + k];
#pragma unroll
          for (int j = 0; j < PJ; ++j) sv[j] = st[(lane + 32 * j) * LDN + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + r0 + i;
          if (l >= qv) continue;
          const float e = expf(cs[l]);
          T* yr = y + ((row0 + l) * H + hh) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            store(yr + lane + 32 * j, acc[i][j] + e * off[i][j]);
        }
      }
      __syncthreads();                  // Mt is rewritten by the next tile
    }

    // ---- state update (every read of the old state is behind the barrier)
    {
      const int kl = lane % KL, pr = lane / KL;
      float acc[PI][KJ];
#pragma unroll
      for (int ii = 0; ii < PI; ++ii)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) acc[ii][jj] = 0.f;
      for (int s = 0; s < qv; ++s) {
        const float w = wv[s];
        float xv[PI], bv[KJ];
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
          xv[ii] = xs[s * P + pr + RPW * (warp + kWarps * ii)] * w;
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) bv[jj] = Bs[s * LDN + kl + KL * jj];
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
#pragma unroll
          for (int jj = 0; jj < KJ; ++jj)
            acc[ii][jj] = fmaf(xv[ii], bv[jj], acc[ii][jj]);
      }
      const float dec = expf(cs[q - 1]);
#pragma unroll
      for (int ii = 0; ii < PI; ++ii)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          float* sp = st + (pr + RPW * (warp + kWarps * ii)) * LDN + kl +
                      KL * jj;
          *sp = dec * *sp + acc[ii][jj];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    fin[st_off + e] = st[(e / N) * LDN + e % N];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* fin, int b, int S, int H, int q, long long x_bs,
                   long long x_row, long long bc_bs, long long bc_row,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(P, N, q);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, P, N><<<b * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fin, S, H, q,
      x_bs, x_row, bc_bs, bc_row);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fin, int b, int S, int H, int n, int q,
                       long long x_bs, long long x_row, long long bc_bs,
                       long long bc_row, cudaStream_t s) {
#define SSD_CASE(NN)                                                        \
  if (n == NN)                                                              \
    return launch<T, P, NN>(x, dt, A, Bm, Cm, init, y, fin, b, S, H, q,     \
                            x_bs, x_row, bc_bs, bc_row, s);
  SSD_CASE(16)
  SSD_CASE(32)
  SSD_CASE(64)
  SSD_CASE(128)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_p(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fin, int b, int S, int H, int p, int n,
                       int q, long long x_bs, long long x_row,
                       long long bc_bs, long long bc_row, cudaStream_t s) {
  if (p == 32)
    return dispatch_n<T, 32>(x, dt, A, Bm, Cm, init, y, fin, b, S, H, n, q,
                             x_bs, x_row, bc_bs, bc_row, s);
  if (p == 64)
    return dispatch_n<T, 64>(x, dt, A, Bm, Cm, init, y, fin, b, S, H, n, q,
                             x_bs, x_row, bc_bs, bc_row, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). `init` may be null (zero initial state). Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* fin, int b,
                               int S, int H, int p, int n, int q,
                               long long x_bs, long long x_row,
                               long long bc_bs, long long bc_row, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (b <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kQMax)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto dtp = static_cast<const float*>(dt);
  auto Ap = static_cast<const float*>(A);
  auto ip = static_cast<const float*>(init);
  auto fp = static_cast<float*>(fin);
  if (dtype == kFloat32)
    return (int)dispatch_p<float>(x, dtp, Ap, Bm, Cm, ip, y, fp, b, S, H, p,
                                  n, q, x_bs, x_row, bc_bs, bc_row, s);
  if (dtype == kBFloat16)
    return (int)dispatch_p<__nv_bfloat16>(x, dtp, Ap, Bm, Cm, ip, y, fp, b,
                                          S, H, p, n, q, x_bs, x_row, bc_bs,
                                          bc_row, s);
  return (int)cudaErrorInvalidValue;
}

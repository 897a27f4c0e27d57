// One-token GQA decode attention through a block table into a shared KV page
// pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_flash_decode_bkhd` (`_paged_decode_kernel`)
// of src/repro/kernels/paged/decode.py: q (B,KV,G,hd) attends to the pages
// `tables[b, j]` of k/v pools (KV,P,ps,hd), over the first lengths[b] tokens
// of the row (capped at n_pages * ps); online softmax with fp32 (m, l, acc);
// scores are scaled by 1/sqrt(hd), then soft-capped (tanh, when
// softcap > 0); l is floored at 1e-30, so a row with length 0 gives zeros.
//
// What bounds it on this card: bytes. A call reads the live pages of every
// row once (at most 4.7 MB at the serve path's B=8, KV=4, 36 pages of 16,
// hd=64 in bf16) for ~2 flops per byte, far below the ~295 flop/byte at
// which the tensor cores become the limit.
//
// What the design does about it: one CTA per (b, kv-head) keeps the G
// query rows of the group resident in shared memory, so each live page is
// read from device memory once for all G heads that share it, with 16-byte
// vector loads. A tile is 64 consecutive positions of the row; the CTA
// looks up the page of each position from the row's table (explicit row
// stride, so a column slice of the engine's table passes without a copy)
// and loads only positions below the row's length. Table entries past the
// row's live pages are never read, and neither is any position past the
// length inside the tail page: unlike the TPU kernel, which fetches every
// table entry up to n_pages and needs them to be valid page ids, this
// kernel does not depend on the trash-page convention, and poisoned (NaN)
// pages past the length cannot reach the output. Known shortfall, as in
// flash_decode.cu: B*KV CTAs (32 at the serve shapes) underfill the 132 SMs
// and each tile is loaded, then computed, with no overlap; split-K over
// pages with a combine pass and cp.async/TMA double buffering are next.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;       // sequence positions per shared-memory tile
constexpr int kMaxAcc = 32;   // accumulators per thread: G*hd <= 4096

// Copy positions p0 .. p0+rows-1 of one row into fp32 shared memory (row
// stride `ld`). Position p lives at offset p % ps of page pid[p - p0];
// hd % Vec<T>::n == 0, so no vector straddles two positions.
template <typename T>
__device__ void load_positions(const T* __restrict__ pool,
                               const int* __restrict__ pid, int p0, int rows,
                               int ps, int hd, float* dst, int ld) {
  constexpr int V = Vec<T>::n;
  const int n = rows * hd;
  for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
    const int r = i / hd, c = i % hd;
    const T* src = pool + ((size_t)pid[r] * ps + (p0 + r) % ps) * hd + c;
    float e[V];
    load_vec(src, e);
#pragma unroll
    for (int u = 0; u < V; ++u) dst[r * ld + c + u] = e[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int G, int P, int ps, int hd, int n_pages,
                    int tstride, float scale, float softcap) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;                 // padded: conflict-free score loop
  int* pid_s = reinterpret_cast<int*>(smem);   // (kBK,) page id per row
  float* qs = smem + kBK;                 // (G, hd)
  float* ks = qs + G * hd;                // (kBK, hd+1)
  float* vs = ks + kBK * ldk;             // (kBK, hd)
  float* pr_s = vs + kBK * hd;            // (G, kBK) scores, then probs
  float* m_s = pr_s + G * kBK;            // (G,) running max
  float* l_s = m_s + G;                   // (G,) running sum
  float* a_s = l_s + G;                   // (G,) this tile's rescale

  const int bh = blockIdx.x;              // b * KV + kv-head
  const int b = bh / KV, h = bh % KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int GH = G * hd;
  const T* kp = kpool + (size_t)h * P * ps * hd;
  const T* vp = vpool + (size_t)h * P * ps * hd;
  const int* trow = tables + (size_t)b * tstride;
  // live positions: the row's length, capped at the table's n_pages pages
  const int len = max(0, min(lengths[b], n_pages * ps));

  {                                       // q rows of the group -> fp32
    constexpr int V = Vec<T>::n;
    const T* qp = q + (size_t)bh * GH;
    for (int i = tid * V; i < GH; i += blockDim.x * V) {
      float e[V];
      load_vec(qp + i, e);
#pragma unroll
      for (int u = 0; u < V; ++u) qs[i + u] = e[u];
    }
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int p0 = 0; p0 < len; p0 += kBK) {
    const int rows = min(kBK, len - p0);  // every row of the tile is live
    __syncthreads();                      // previous tile fully consumed
    for (int r = tid; r < rows; r += blockDim.x)
      pid_s[r] = trow[(p0 + r) / ps];     // only the row's live entries
    __syncthreads();
    load_positions(kp, pid_s, p0, rows, ps, hd, ks, ldk);
    load_positions(vp, pid_s, p0, rows, ps, hd, vs, hd);
    __syncthreads();
    // scores for every (g, j) of the tile: x 1/sqrt(hd), then softcap
    for (int e = tid; e < G * kBK; e += blockDim.x) {
      const int g = e / kBK, j = e % kBK;
      float s = kNegInf;                  // past the length: masked
      if (j < rows) {
        const float* qr = qs + g * hd;
        const float* kr = ks + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      }
      pr_s[e] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row of the group
    for (int g = warp; g < G; g += nwarps) {
      float* pr = pr_s + g * kBK;
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
        const float* pr = pr_s + g * kBK;
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

// Dynamic shared memory of one launch (paged_decode.py SMEM_* mirrors it;
// the wrapper refuses shapes above the card's 227 KB per block).
size_t smem_bytes(int G, int hd) {
  return sizeof(int) * (size_t)kBK +
         sizeof(float) * ((size_t)G * hd + (size_t)kBK * (hd + 1) +
                          (size_t)kBK * hd + (size_t)G * kBK + 3 * (size_t)G);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, void* out, int B,
                   int KV, int G, int P, int ps, int hd, int n_pages,
                   int tstride, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), KV, G,
      P, ps, hd, n_pages, tstride, 1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* tables,
                                   const void* lengths, void* out, int B,
                                   int KV, int G, int P, int ps, int hd,
                                   int n_pages, int tstride, float softcap,
                                   int dtype, void* stream) {
  using namespace repro_torch;
  if (G * hd > kThreads * kMaxAcc || hd % 8 != 0 || ps <= 0 || n_pages < 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tp = static_cast<const int*>(tables);
  auto lp = static_cast<const int*>(lengths);
  if (dtype == kFloat32)
    return (int)launch<float>(q, k, v, tp, lp, out, B, KV, G, P, ps, hd,
                              n_pages, tstride, softcap, s);
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16>(q, k, v, tp, lp, out, B, KV, G, P, ps,
                                      hd, n_pages, tstride, softcap, s);
  return (int)cudaErrorInvalidValue;
}

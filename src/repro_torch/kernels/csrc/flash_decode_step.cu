// The decode step of GQA attention over a dense KV cache, bf16 at hd 256,
// on Hopper's tensor cores (sm_90a): gemma-2b's decode step.
//
// Replaces, at this head dim, the TPU kernel `flash_decode_bkhd`
// (`_decode_kernel`) of src/repro/kernels/flash_decode.py. q (B,KV,G,hd)
// attends to k/v (B,KV,C,hd) with an additive fp32 bias (B,C). Every score
// is scaled by 1/sqrt(hd), then soft-capped (tanh, when softcap > 0), then
// biased, in that order; softmax with fp32 (m, l, acc); l is floored at
// 1e-30. fp32, other head dims and the chunk forms keep their kernels
// (flash_decode.cu, flash_decode_chunk.cu); this file is its own library so
// that their binaries stay as they were.
//
// What bounds it on this card: bytes. At gemma-2b's decode step (B 8, 8
// query heads on one KV head, C 576) a call reads 4.7 MB of K and V for
// ~2 flops a byte: ~1.4 us at 3.35 TB/s. In practice a launch's fixed
// latency, the latency of one wave of loads and the split combine's L2
// reads are the floor: all three grow with what runs in sequence, so the
// design keeps every CTA to one round of loads.
//
// The design (`flash_decode_step_kernel`):
// - Fill the card. The cache axis of each (b, kv-head) is split over
//   `splits` CTAs (the wrapper's STEP_SPLITS: at gemma's B 8 and KV 1, 18
//   splits of 32 positions give 144 CTAs on the 132 SMs, where the
//   CUDA-core kernel's 8 gave 64). A CTA is four warps and 80,896 bytes of
//   shared memory, so two fit an SM and no CTA waits for a second wave.
// - All of a split's positions in flight at once: its Q rows, K and V
//   (up to 64 positions, 64 KB) are copied with one round of 16-byte
//   `cp.async`s and one wait. A split longer than 64 positions (C above 64
//   x splits) walks 64-position tiles with an online softmax.
// - The products on the tensor cores: the G query rows are the M of
//   `mma.sync.m16n8k16` (rows G .. 15 load as zeros and are never stored).
//   QK^T: warp w scores positions 16w .. 16w + 15 over hd in two
//   independent accumulator chains. The scores are scaled, soft-capped and
//   biased, the row max and sum are taken across the four warps through
//   shared memory, and P goes to shared memory in fp32. PV: warp w keeps
//   output columns 64w .. 64w + 63 (32 fp32 accumulators a thread) and
//   takes P as hi + lo bf16 A fragments (one bf16 P moves an output by up
//   to 2^-9 of its size, past the 1e-2 check), V through `ldmatrix.trans`.
//   Shared rows are hd + 8 bf16, so the 8 rows an `ldmatrix` reads start
//   in 8 different bank groups.
// - Deterministic combine: each split writes its partial (acc (16, hd), m,
//   l) to the shared workspace and the last CTA to arrive combines them in
//   split order (weights exp(m_s - M) / L), never in arrival order, so a
//   replay equals an eager call bitwise (wg_arrive_and_combine, wgmma.cuh,
//   the chunk forms' combine over 16-row partials). It leaves the arrival
//   counter at zero. A split with no position (C below the split count, C
//   = 1) writes m = -1e30, l = 0 and zeros: weight 0.
//   Positions under a -1e9 bias enter exactly as in the plain version:
//   s + bias in fp32, then exp of its difference to the row max.
// Measured (device ms at gemma's decode step, NVIDIA H100 80GB HBM3 at
// 700 W): 0.0125 at 18 splits in chip_smoke --ab, SDPA 0.0131, bound
// 0.0014. By split count (--ab's sweep): 8: 0.0116, 12: 0.0106, 16:
// 0.0113, 18: 0.0125, 24: 0.0134, 36: 0.0193. Without its combine
// (kernel_variants.py, a wrong result on purpose) the kernel takes
// 0.0065-0.0068 from 12 to 24 splits: the last CTA's L2 reads of 18 x 8
// KB of partials are most of the rest, and they grow with the splits. 12
// splits (96 CTAs) read 15% faster than 18 but leave 36 SMs idle; 18 is
// the fastest count that fills the card. Tried and left out (--ab): the
// CUDA-core kernel (flash_decode.cu: fp32 FMAs, 8 splits, 64 CTAs, two
// 64-position tiles a split), 0.0303; the tensor-core chunk kernel called
// with ck = 1 (flash_decode_chunk.cu: 8 live rows of a 64-row `wgmma`
// block), 0.0151 at its 4 splits and 0.0124-0.0128 at 9.
#include "wgmma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 256;
constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // the mma M: G query rows, the rest zero
constexpr int kPos = 64;          // positions of one K/V tile: 16 a warp
constexpr int kLd = HD + 8;       // bf16 elements of a shared Q/K/V row
constexpr int kLdP = kPos + 4;    // floats of a shared row of P
constexpr int kChunks = HD / 8;   // 16-byte chunks of a row
constexpr int kMaxSplits = 64;
// Q | K tile | V tile (bf16) | P | row max and row sum per warp (fp32)
constexpr size_t kSmemBytes =
    sizeof(bf16) * (size_t)(kRows + 2 * kPos) * kLd +
    sizeof(float) * ((size_t)kRows * kLdP + 2 * kWarps * kRows);
// one split's partial: acc (16, HD), m (16), l (16)
constexpr size_t kSplitFloats = (size_t)kRows * HD + 2 * kRows;

__global__ void __launch_bounds__(kThreads)
flash_decode_step_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         bf16* __restrict__ out, float* __restrict__ partials,
                         int* __restrict__ arrivals, int KV, int G, int C,
                         float scale, float softcap) {
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * kLd;
  bf16* Vs = Ks + kPos * kLd;
  float* Ps = reinterpret_cast<float*>(Vs + kPos * kLd);  // (16, kLdP)
  float* red_max = Ps + kRows * kLdP;                      // (4 warps, 16)
  float* red_sum = red_max + kWarps * kRows;               // (4 warps, 16)

  const int split = blockIdx.x, splits = gridDim.x;
  const int bh = blockIdx.y, b = bh / KV, h = bh % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const int chunk = (C + splits - 1) / splits;
  const int c0 = min(C, split * chunk), n = min(C, c0 + chunk) - c0;
  const bf16* kp = k + ((size_t)bh * C + c0) * HD;
  const bf16* vp = v + ((size_t)bh * C + c0) * HD;
  const float* bp = bias + (size_t)b * C + c0;

  if (n > 0) {                           // Q: G rows, then zeros
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r < G;
      cp_async16(Qs + r * kLd + c * 8,
                 q + ((size_t)bh * G + (ok ? r : 0)) * HD + c * 8, ok);
    }
  }

  // accumulator o[nn][e]: row g + (e / 2) * 8, column 64 warp + 8 nn + 2t
  // + e % 2
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the biased scores
  float l[2] = {0.f, 0.f};              // the row's sum (every warp's)
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int j0 = 0; j0 < n; j0 += kPos) {
    const int rows = min(kPos, n - j0);
    const int rows16 = (rows + 15) & ~15;  // positions the products cover
    if (j0 > 0) __syncthreads();          // the last tile is consumed
    // the whole tile in one round of copies; rows past `rows` zero-filled
    for (int i = threadIdx.x; i < rows16 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r < rows;
      const size_t src = (size_t)(j0 + (ok ? r : 0)) * HD + c * 8;
      cp_async16(Ks + r * kLd + c * 8, kp + src, ok);
      cp_async16(Vs + r * kLd + c * 8, vp + src, ok);
    }
    cp_async_commit();
    // this thread's biases (positions 16 warp + 8 jn + 2t + e % 2), read
    // while the tile lands; positions past `rows` score -inf
    float bv[2][2];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pos = 16 * warp + 8 * jn + 2 * t + u;
        bv[jn][u] = pos < rows ? __ldg(bp + j0 + pos) : -INFINITY;
      }
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T: this warp's 16 positions (two 8-wide tiles), the 16
    // k-steps over hd in two chains
    float s[2][2][4];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ch][jn][e] = 0.f;
    if (16 * warp < rows) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, Qs + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(kb, Ks + (16 * warp + (lane & 7) + ((lane >> 4) << 3)) *
                                 kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[kk & 1][0], qa, kb[0], kb[1]);
        mma_bf16(s[kk & 1][1], qa, kb[2], kb[3]);
      }
    }
    // x 1/sqrt(hd), softcap, + bias; this warp's row max (4 lanes a row)
    float x[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = (s[0][jn][e] + s[1][jn][e]) * scale;
        if (softcap > 0.f) y = tanhf(y * inv_cap) * softcap;
        y += bv[jn][e & 1];
        x[jn][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) red_max[warp * kRows + g + 8 * r] = mx[r];
    }
    __syncthreads();
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = red_max[g + 8 * r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        tmax = fmaxf(tmax, red_max[w * kRows + g + 8 * r]);
      const float m_new = fmaxf(m[r], tmax);
      ref[r] = m_new == -INFINITY ? 0.f : m_new;
      // the difference first: exact for scores near -1e9, as in the plain
      // version's softmax
      alpha[r] = ex2((m[r] - ref[r]) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((x[jn][e] - ref[e >> 1]) * kLog2e);
        sum[e >> 1] += p;
        Ps[(g + 8 * (e >> 1)) * kLdP + 16 * warp + 8 * jn + 2 * t +
           (e & 1)] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (t == 0) red_sum[warp * kRows + g + 8 * r] = sum[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tsum = red_sum[g + 8 * r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tsum += red_sum[w * kRows + g + 8 * r];
      l[r] = l[r] * alpha[r] + tsum;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        o[nn][2 * r] *= alpha[r];
        o[nn][2 * r + 1] *= alpha[r];
      }
    }

    // O += P V over the tile's positions, 16 a k-step: this warp's 64
    // columns, P as hi + lo bf16
    for (int kk = 0; kk < rows16 / 16; ++kk) {
      const float* p0 = Ps + g * kLdP + kk * 16 + 2 * t;
      const float* p1 = p0 + 8 * kLdP;
      uint32_t ah[4], al[4];
      split_bf16(p0[0], p0[1], ah[0], al[0]);
      split_bf16(p1[0], p1[1], ah[1], al[1]);
      split_bf16(p0[8], p0[9], ah[2], al[2]);
      split_bf16(p1[8], p1[9], ah[3], al[3]);
      uint32_t vb[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4_trans(vb[np], Vs + (kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * kLd +
                                      64 * warp + np * 16 + (lane >> 4) * 8);
      // all hi products, then all lo: no accumulator is reused back to back
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(o[2 * np], ah, vb[np][0], vb[np][1]);
        mma_bf16(o[2 * np + 1], ah, vb[np][2], vb[np][3]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(o[2 * np], al, vb[np][0], vb[np][1]);
        mma_bf16(o[2 * np + 1], al, vb[np][2], vb[np][3]);
      }
    }
  }
  cp_async_wait<0>();

  // publish this split's partial (the G live rows); the last to arrive
  // combines
  float* pb = partials + (size_t)bh * splits * kSplitFloats;
  float* my = pb + (size_t)split * kSplitFloats;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= G) continue;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<float2*>(my + row * HD + 64 * warp + 8 * nn +
                                 2 * t) =
          make_float2(o[nn][2 * r], o[nn][2 * r + 1]);
    if (warp == 0 && t == 0) {
      my[kRows * HD + row] = m[r] == -INFINITY ? kNegInf : m[r];
      my[kRows * HD + kRows + row] = l[r];
    }
  }
  __threadfence();
  wg_arrive_and_combine<HD, kRows>(pb, arrivals + bh, splits, G, kLog2e,
                                   reinterpret_cast<float*>(smem_raw), out,
                                   b, h, 0, 1, KV, G);
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, KV, G, hd) bf16, k and v (B, KV, C, hd) bf16, bias
// (B, C) fp32; `splits` CTAs per (b, kv-head) (flash_decode_chunk_launch's
// arguments: ck must be 1). `partials` holds B*KV*splits*(16*hd + 2*16)
// floats and `arrivals` B*KV ints, zero before the launch and left at zero
// after it. `dtype` must be bf16, `hd` 256 and G at most 16: what this
// kernel takes.
extern "C" int flash_decode_step_launch(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, void* partials,
                                        void* arrivals, int B, int KV, int G,
                                        int C, int hd, int ck, int splits,
                                        float softcap, int dtype,
                                        void* stream) {
  using namespace repro_torch;
  if (dtype != kBFloat16 || hd != HD || ck != 1 || B <= 0 || KV <= 0 ||
      G <= 0 || G > kRows || C <= 0 || splits < 1 || splits > kMaxSplits ||
      (long)B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  flash_decode_step_kernel<<<dim3(splits, B * KV), kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(partials),
      static_cast<int*>(arrivals), KV, G, C, 1.0f / sqrtf((float)HD),
      softcap);
  return (int)cudaGetLastError();
}

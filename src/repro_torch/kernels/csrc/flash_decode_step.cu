// The decode step of GQA attention over a dense KV cache, bf16 at hd 128
// and 256, on Hopper's tensor cores (sm_90a): internvl2-26b's, yi-6b's
// and deepseek-67b's decode step (hd 128), gemma-2b's (hd 256).
//
// Replaces, at these head dims, the TPU kernel `flash_decode_bkhd`
// (`_decode_kernel`) of src/repro/kernels/flash_decode.py. q (B,KV,G,hd)
// attends to k/v (B,KV,C,hd) with an additive fp32 bias (B,C). Every score
// is scaled by 1/sqrt(hd), then soft-capped (tanh, when softcap > 0), then
// biased, in that order; softmax with fp32 (m, l, acc); l is floored at
// 1e-30. fp32, hd 64 and the chunk forms keep their kernels
// (flash_decode.cu, flash_decode_chunk.cu); this file is its own library so
// that their binaries stay as they were.
//
// What bounds it on this card: bytes. At gemma-2b's decode step (B 8, 8
// query heads on one KV head, C 576) a call reads 4.7 MB of K and V for
// ~2 flops a byte: ~1.4 us at 3.35 TB/s; at internvl2-26b's (B 8, 48
// query heads on 8 KV heads of hd 128: G 6) 18.9 MB, ~5.7 us. In practice
// a launch's fixed latency, the latency of the loads and the split
// combine are the floor: all three grow with what runs in sequence.
//
// The design (`flash_decode_step_kernel<HD>`):
// - Split the cache axis. Each (b, kv-head)'s C positions are split over
//   `splits` CTAs, 1 to 8, which form one thread block cluster (the
//   wrapper's STEP_SPLITS, by head dim: 6 at internvl's 64 (b, kv) pairs,
//   384 CTAs; 8 at gemma's 8, 64 CTAs). A CTA is four warps and
//   2 (16 + 128) (HD + 8) + 4 (16 x 68 + 128) bytes of shared memory:
//   80,896 at hd 256 (two CTAs an SM), 44,032 at hd 128 (five).
// - A split's positions in flight at once: its Q rows, K and V (up to 64
//   positions) are copied with one round of 16-byte `cp.async`s and one
//   wait. A split longer than 64 positions walks 64-position tiles with
//   an online softmax.
// - The products on the tensor cores: the G query rows are the M of
//   `mma.sync.m16n8k16` (rows G .. 15 load as zeros and are never stored).
//   QK^T: warp w scores positions 16w .. 16w + 15 over hd (HD / 16
//   k-steps) in two independent accumulator chains. The scores are scaled,
//   soft-capped and biased, the row max and sum are taken across the four
//   warps through shared memory, and P goes to shared memory in fp32. PV:
//   warp w keeps output columns HD/4 w .. HD/4 (w + 1) - 1 (HD / 8 fp32
//   accumulators a thread) and takes P as hi + lo bf16 A fragments (one
//   bf16 P moves an output by up to 2^-9 of its size, past the 1e-2
//   check), V through `ldmatrix.trans`. Shared rows are hd + 8 bf16, so
//   the 8 rows an `ldmatrix` reads start in 8 different bank groups.
// - The split combine stays on chip: each split leaves its partial (acc
//   (G, hd), m, l) in its own shared memory, the cluster meets at a
//   barrier, and each CTA combines a sixth (an eighth, ...) of the G x hd
//   outputs by reading every split's slice through distributed shared
//   memory, in split order (weights exp(m_s - M) / L), never in arrival
//   order, so a replay equals an eager call bitwise; a second barrier
//   keeps each partial alive until its readers are done. No device-memory
//   workspace, no arrival counter. A split with no position (C below the
//   split count, C = 1) leaves m = -1e30, l = 0 and zeros: weight 0.
//   Positions under a -1e9 bias enter exactly as in the plain version:
//   s + bias in fp32, then exp of its difference to the row max.
// Measured (device ms, NVIDIA H100 80GB HBM3 at 700 W; chip_smoke --ab,
// parent and change in one call): internvl's step 0.0137 (the CUDA-core
// kernel 0.0467, SDPA 0.0149, bound 0.0057), gemma's 0.0092 (before the
// cluster 0.0124, SDPA 0.0131, bound 0.0014). By split count (--ab's
// sweep): internvl 2: 0.0174, 3: 0.0143, 4: 0.0150, 5: 0.0138, 6:
// 0.0137, 7: 0.0141, 8: 0.0147; gemma 2: 0.0174, 4: 0.0115, 6: 0.0098,
// 8: 0.0093. ptxas: 71 registers at hd 128, no spill (five CTAs an SM
// need at most 102); 96 at hd 256. Without its combine (kernel_variants.py,
// a wrong result on purpose) the kernel takes 0.0105 at internvl's 6
// splits and 0.0064 at gemma's 8: the cluster's two barriers and its
// reads of the peers' partials are the rest, ~0.003, and what holds the
// kernel at 2.4x (internvl) and 6.5x (gemma) its bound is one round of
// loads and products a CTA in a single wave, not the bytes.
// The combine before the cluster (the last CTA to arrive read every
// split's partial from L2, wg_arrive_and_combine in wgmma.cuh) cost
// 0.003-0.004 ms at either head dim and grew with the splits: at gemma 18
// splits 0.0125 (0.0065-0.0068 without the combine), at internvl 6 / 9
// splits 0.0150 / 0.0163 (0.0120 without); clusters above 8 CTAs
// (non-portable) ran slower (internvl 9: 0.0178). Tried and left out
// (--ab): the CUDA-core kernel (flash_decode.cu: fp32 FMAs, 8 splits, two
// 64-position tiles a split), gemma 0.0303, internvl 0.0469; the
// tensor-core chunk kernel called with ck = 1 (flash_decode_chunk.cu: G
// live rows of a 64-row `wgmma` block), gemma 0.0151 at its 4 splits and
// 0.0124-0.0128 at 9, internvl 0.0173 at 4.
#include "wgmma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // the mma M: G query rows, the rest zero
constexpr int kPos = 64;          // positions of one K/V tile: 16 a warp
constexpr int kLdP = kPos + 4;    // floats of a shared row of P
// splits of a (b, kv-head): one cluster, up to a portable cluster's 8 CTAs
constexpr int kMaxSplits = 8;
// Q | K tile | V tile (bf16, rows of HD + 8) | P | row max and row sum per
// warp (fp32)
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(kRows + 2 * kPos) * (HD + 8) +
         sizeof(float) * ((size_t)kRows * kLdP + 2 * kWarps * kRows);
}

// ---- the split combine inside a thread block cluster: the cluster is one
// (b, kv-head)'s `splits` CTAs, rank s = split s (gridDim.x = splits)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared address `addr` of this CTA, in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// Publish this split's partial (the thread's accumulator rows g and g + 8,
// kNt 8-column tiles from column kCols warp, its rows' m and l) in its own
// shared memory at `part` (16 rows of HD + 4 floats, then m (16) and l
// (16)), then combine the cluster's partials into out_bh (this (b,
// kv-head)'s G rows of HD, bf16) in split order: weights exp(m_s - M) / L,
// L floored at 1e-30, as wg_arrive_and_combine. CTA `split` takes a
// contiguous 1/splits of the G x HD/4 four-column items and reads each
// split's slice of them through distributed shared memory. `stage` holds
// 2 x splits x 16 floats. Every thread of every CTA of the cluster calls
// it; nothing goes through device memory and nothing depends on arrival
// order.
template <int HD, int kNt>
__device__ void cluster_publish_and_combine(
    float* part, float* stage, const float (&o)[kNt][4], const float (&m)[2],
    const float (&l)[2], int G, int split, int splits,
    bf16* __restrict__ out_bh) {
  constexpr int kLdPart = HD + 4, kCols = HD / kWarps, kQ = HD / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= G) continue;
#pragma unroll
    for (int nn = 0; nn < kNt; ++nn)
      *reinterpret_cast<float2*>(part + row * kLdPart + kCols * warp +
                                 8 * nn + 2 * t) =
          make_float2(o[nn][2 * r], o[nn][2 * r + 1]);
    if (warp == 0 && t == 0) {
      part[kRows * kLdPart + row] = m[r] == -INFINITY ? kNegInf : m[r];
      part[kRows * kLdPart + kRows + row] = l[r];
    }
  }
  cluster_sync();                 // every split's partial is in place
  const uint32_t base = smem_addr(part);
  for (int i = threadIdx.x; i < splits * kRows; i += kThreads) {
    const uint32_t a =
        map_rank(base + 4 * (kRows * kLdPart + i % kRows), i / kRows);
    stage[i] = ld_peer(a);                          // m, then its weight
    stage[splits * kRows + i] = ld_peer(a + 4 * kRows);   // l
  }
  __syncthreads();
  for (int row = threadIdx.x; row < G; row += kThreads) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, stage[s * kRows + row]);
    for (int s = 0; s < splits; ++s) {
      const float w = ex2((stage[s * kRows + row] - M) * kLog2e);
      stage[s * kRows + row] = w;
      L = fmaf(stage[(splits + s) * kRows + row], w, L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < splits; ++s) stage[s * kRows + row] *= inv;
  }
  __syncthreads();
  const int n = G * kQ, per = (n + splits - 1) / splits;
  for (int i = split * per + threadIdx.x; i < min(n, (split + 1) * per);
       i += kThreads) {
    const int row = i / kQ, d = 4 * (i % kQ);
    const uint32_t a = base + 4 * (row * kLdPart + d);
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 4) {   // four reads in flight
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < splits) v[u] = ld_peer4(map_rank(a, s0 + u));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u >= splits) break;
        const float w = stage[(s0 + u) * kRows + row];
        O.x = fmaf(v[u].x, w, O.x);
        O.y = fmaf(v[u].y, w, O.y);
        O.z = fmaf(v[u].z, w, O.z);
        O.w = fmaf(v[u].w, w, O.w);
      }
    }
    uint2 packed;
    packed.x = pack_bf16(O.x, O.y);
    packed.y = pack_bf16(O.z, O.w);
    *reinterpret_cast<uint2*>(out_bh + row * HD + d) = packed;
  }
  cluster_sync();                 // no CTA leaves while a peer reads it
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_step_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         bf16* __restrict__ out, int KV, int G, int C,
                         float scale, float softcap) {
  constexpr int kLd = HD + 8;       // bf16 elements of a shared Q/K/V row
  constexpr int kChunks = HD / 8;   // 16-byte chunks of a row
  constexpr int kCols = HD / kWarps;  // output columns of a warp in PV
  constexpr int kNt = kCols / 8;    // its 8-wide accumulator tiles
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

  // accumulator o[nn][e]: row g + (e / 2) * 8, column kCols warp + 8 nn
  // + 2t + e % 2
  float o[kNt][4];
#pragma unroll
  for (int nn = 0; nn < kNt; ++nn)
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

    // S = Q K^T: this warp's 16 positions (two 8-wide tiles), the HD / 16
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
      for (int nn = 0; nn < kNt; ++nn) {
        o[nn][2 * r] *= alpha[r];
        o[nn][2 * r + 1] *= alpha[r];
      }
    }

    // O += P V over the tile's positions, 16 a k-step: this warp's kCols
    // columns, P as hi + lo bf16
    for (int kk = 0; kk < rows16 / 16; ++kk) {
      const float* p0 = Ps + g * kLdP + kk * 16 + 2 * t;
      const float* p1 = p0 + 8 * kLdP;
      uint32_t ah[4], al[4];
      split_bf16(p0[0], p0[1], ah[0], al[0]);
      split_bf16(p1[0], p1[1], ah[1], al[1]);
      split_bf16(p0[8], p0[9], ah[2], al[2]);
      split_bf16(p1[8], p1[9], ah[3], al[3]);
      uint32_t vb[kNt / 2][4];
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np)
        ldmatrix_x4_trans(vb[np], Vs + (kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * kLd +
                                      kCols * warp + np * 16 +
                                      (lane >> 4) * 8);
      // all hi products, then all lo: no accumulator is reused back to back
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        mma_bf16(o[2 * np], ah, vb[np][0], vb[np][1]);
        mma_bf16(o[2 * np + 1], ah, vb[np][2], vb[np][3]);
      }
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        mma_bf16(o[2 * np], al, vb[np][0], vb[np][1]);
        mma_bf16(o[2 * np + 1], al, vb[np][2], vb[np][3]);
      }
    }
  }
  cp_async_wait<0>();
  // the partial goes where the K tile was: every warp has read it (the
  // softmax's barriers follow the last QK^T)
  cluster_publish_and_combine<HD, kNt>(reinterpret_cast<float*>(Ks), Ps, o,
                                       m, l, G, split, splits,
                                       out + (size_t)bh * G * HD);
}

// Set the kernel's shared memory and launch it: `splits` CTAs along x, one
// (b, kv-head) each along y, the splits of a (b, kv-head) one cluster.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int KV, int G, int C,
                   int splits, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_decode_step_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), KV, G, C, 1.0f / sqrtf((float)HD), softcap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, KV, G, hd) bf16, k and v (B, KV, C, hd) bf16, bias
// (B, C) fp32; `splits` CTAs per (b, kv-head), 1 to 8, one cluster
// (flash_decode_chunk_launch's arguments: ck must be 1; `partials` and
// `arrivals` are not used: the splits combine in the cluster's shared
// memory). `dtype` must be bf16, `hd` 128 or 256 and G at most 16: what
// this kernel takes.
extern "C" int flash_decode_step_launch(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, void* /*partials*/,
                                        void* /*arrivals*/, int B, int KV,
                                        int G, int C, int hd, int ck,
                                        int splits, float softcap, int dtype,
                                        void* stream) {
  using namespace repro_torch;
  if (dtype != kBFloat16 || (hd != 128 && hd != 256) || ck != 1 || B <= 0 ||
      KV <= 0 || G <= 0 || G > kRows || C <= 0 || splits < 1 ||
      splits > kMaxSplits || (long)B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch<128>(q, k, v, bias, out, B, KV, G, C,
                                       splits, softcap, s)
                         : launch<256>(q, k, v, bias, out, B, KV, G, C,
                                       splits, softcap, s));
}

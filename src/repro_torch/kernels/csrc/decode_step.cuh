// The decode step of GQA attention on Hopper's tensor cores (sm_90a), bf16
// at hd 64, 128 and 256: one query token per (b, kv-head) row of G <= 16
// query heads. The body shared by the dense step (flash_decode_step.cu:
// K/V rows of a (B, KV, C, hd) cache under an additive bias) and the paged
// step (paged_decode_step.cu: K/V rows gathered through a block table from
// (KV, P, ps, hd) pools, up to each row's length); the two differ only in
// their loader (`DenseRows`, `PagedRows`): how many positions a row has,
// where position t's K and V rows live, and its bias.
//
// Every score is scaled by 1/sqrt(hd), then soft-capped (tanh, when
// softcap > 0), then biased, in that order; softmax with fp32 (m, l, acc);
// l is floored at 1e-30, so a row with no live position gives zeros.
//
// What bounds it on this card: bytes, ~2 flops a byte read. In practice a
// launch's fixed latency, the latency of the loads and the split combine
// are the floor: all three grow with what runs in sequence.
//
// The design (`decode_step<HD, POS>`):
// - Split the positions. A row's `live` positions (C dense; min(length,
//   n_pages * ps) paged) are split over `splits` CTAs, 1 to 8, which form
//   one thread block cluster (`split_range`: contiguous, ceil(live /
//   splits) each, from `live` alone). A CTA is four warps and
//   2 (16 + 2 POS) (HD + 8) + 4 (16 (POS + 4) + 128) bytes of shared
//   memory (`smem_bytes`).
// - A split's positions in flight at once: its Q rows, K and V (up to POS
//   positions, 64 or 128) are copied with one round of 16-byte `cp.async`s
//   and one wait: a dense tile in one loop over its 16-byte chunks; a paged
//   tile gathered with a thread's copies in one 16-byte column, the pool
//   rows of four positions resolved before their copies start (one
//   table entry serves K and V). Positions past the
//   split are zero-filled (source size 0) and score -inf, so no position
//   at or past `live`, and no table entry there, is read. A split longer
//   than POS positions walks POS-position tiles with an online softmax.
// - The products on the tensor cores: the G query rows are the M of
//   `mma.sync.m16n8k16` (rows G .. 15 load as zeros and are never stored).
//   QK^T: warp w scores positions POS/4 w .. POS/4 (w + 1) - 1 over hd
//   (HD / 16 k-steps) in two independent accumulator chains. The scores
//   are scaled, soft-capped and biased, the row max and sum are taken
//   across the four warps through shared memory, and P goes to shared
//   memory in fp32. PV: warp w keeps output columns HD/4 w .. HD/4 (w + 1)
//   - 1 (HD / 8 fp32 accumulators a thread: two n8 tiles at hd 64) and
//   takes P as hi + lo bf16 A fragments (one bf16 P moves an output by up
//   to 2^-9 of its size, past the 1e-2 check), V through `ldmatrix.trans`.
//   Shared rows are hd + 8 bf16, so the 8 rows an `ldmatrix` reads start
//   in 8 different bank groups.
// - The split combine stays on chip: each split leaves its partial (acc
//   (G, hd), m, l) in its own shared memory where its K tile was, the
//   cluster meets at a barrier, and each CTA combines a 1/splits of the G x
//   hd outputs by reading every split's slice through distributed shared
//   memory, in split order (weights exp(m_s - M) / L), never in arrival
//   order, so a replay equals an eager call bitwise; a second barrier
//   keeps each partial alive until its readers are done. No device-memory
//   workspace, no arrival counter. A split with no position (live below
//   the split count, live 0) leaves m = -1e30, l = 0 and zeros: weight 0.
//   Positions under a -1e9 bias enter exactly as in the plain version:
//   s + bias in fp32, then exp of its difference to the row max.
#pragma once

#include "wgmma.cuh"

namespace repro_torch {
namespace step {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // the mma M: G query rows, the rest zero
// splits of a row: one cluster, up to a portable cluster's 8 CTAs
constexpr int kMaxSplits = 8;

// Q | K tile | V tile (bf16, rows of HD + 8) | P (16 rows of POS + 4) |
// row max and row sum per warp (fp32)
template <int HD, int POS>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(kRows + 2 * POS) * (HD + 8) +
         sizeof(float) * ((size_t)kRows * (POS + 4) + 2 * kWarps * kRows);
}

// Split `split` of `splits` of a row's `live` positions: [c0, c0 + n).
// From `live` alone (never from a page id); tests/test_torch_decode_step.py
// mirrors it on the host.
__device__ __forceinline__ void split_range(int live, int split, int splits,
                                            int& c0, int& n) {
  const int chunk = (live + splits - 1) / splits;
  c0 = min(live, split * chunk);
  n = min(live, c0 + chunk) - c0;
}

// The dense cache: row bh = b * KV + h has C positions; position t is row
// bh * C + t of k and v, biased by bias[b, t]. A tile's rows are
// contiguous, so it is copied in one loop over its 16-byte chunks.
struct DenseRows {
  static constexpr bool kContiguous = true;
  const bf16* k;
  const bf16* v;
  const float* bias;
  int C;
  __device__ __forceinline__ int live(int) const { return C; }
  __device__ __forceinline__ size_t row(int bh, int, int, int t) const {
    return (size_t)bh * C + t;
  }
  __device__ __forceinline__ float bias_at(int b, int t) const {
    return __ldg(bias + (size_t)b * C + t);
  }
};

// The paged cache: row b has min(lengths[b], n_pages * ps) positions
// (negative lengths count as 0); position t of KV head h is row
// (h * P + tables[b, t / ps]) * ps + t % ps of the pools (KV, P, ps, hd);
// no bias. Table rows are `tstride` ints apart. A tile's rows are gathered
// one position at a time.
struct PagedRows {
  static constexpr bool kContiguous = false;
  const bf16* k;
  const bf16* v;
  const int* tables;
  const int* lengths;
  int P, ps, n_pages, tstride;
  __device__ __forceinline__ int live(int b) const {
    return max(0, min(__ldg(lengths + b), n_pages * ps));
  }
  __device__ __forceinline__ size_t row(int, int b, int h, int t) const {
    const int page = __ldg(tables + (size_t)b * tstride + t / ps);
    return ((size_t)h * P + page) * ps + t % ps;
  }
  __device__ __forceinline__ float bias_at(int, int) const { return 0.f; }
};

// ---- the split combine inside a thread block cluster: the cluster is one
// row's `splits` CTAs, rank s = split s (gridDim.x = splits)
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
// (16)), then combine the cluster's partials into out_bh (this row's G
// query rows of HD, bf16) in split order: weights exp(m_s - M) / L, L
// floored at 1e-30. CTA `split` takes a contiguous 1/splits of the G x
// HD/4 four-column items and reads each split's slice of them through
// distributed shared memory. `stage` holds 2 x splits x 16 floats. Every
// thread of every CTA of the cluster calls it; nothing goes through device
// memory and nothing depends on arrival order.
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

// The step of one CTA: split blockIdx.x of row blockIdx.y (= b * KV + h);
// q and out are (B, KV, G, HD). Called by each library's __global__
// kernel, launched by `launch`.
template <int HD, int POS, class Loader>
__device__ __forceinline__ void decode_step(const bf16* __restrict__ q,
                                            const Loader& ld,
                                            bf16* __restrict__ out, int KV,
                                            int G, float scale,
                                            float softcap) {
  constexpr int kLd = HD + 8;       // bf16 elements of a shared Q/K/V row
  constexpr int kLdP = POS + 4;     // floats of a shared row of P
  constexpr int kChunks = HD / 8;   // 16-byte chunks of a row
  constexpr int kPosW = POS / kWarps;  // positions a warp scores
  constexpr int kJn = kPosW / 8;    // its 8-wide score tiles
  constexpr int kCols = HD / kWarps;  // output columns of a warp in PV
  constexpr int kNt = kCols / 8;    // its 8-wide accumulator tiles
  // a thread's copies of a full tile: rows r0, r0 + kR, ... of column c
  constexpr int kR = kThreads / kChunks;
  constexpr int kIters = POS / kR;
  static_assert(kThreads % kChunks == 0 && kIters % 4 == 0 &&
                    kPosW % 16 == 0 && kNt % 2 == 0,
                "decode_step tile shape");
  static_assert(sizeof(float) * (kRows * (HD + 4) + 2 * kRows) <=
                    sizeof(bf16) * POS * kLd,
                "the partial goes where the K tile was");
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * kLd;
  bf16* Vs = Ks + POS * kLd;
  float* Ps = reinterpret_cast<float*>(Vs + POS * kLd);  // (16, kLdP)
  float* red_max = Ps + kRows * kLdP;                     // (4 warps, 16)
  float* red_sum = red_max + kWarps * kRows;              // (4 warps, 16)

  const int split = blockIdx.x, splits = gridDim.x;
  const int bh = blockIdx.y, b = bh / KV, h = bh % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  int c0, n;
  split_range(ld.live(b), split, splits, c0, n);

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

  for (int j0 = 0; j0 < n; j0 += POS) {
    const int rows = min(POS, n - j0);
    const int rows16 = (rows + 15) & ~15;  // positions PV covers
    // positions QK^T covers: whole warps' ranges, so no warp that scores
    // reads a row this tile did not write (a stale NaN there would reach
    // the row sum)
    const int rowsW = (rows + kPosW - 1) / kPosW * kPosW;
    if (j0 > 0) __syncthreads();          // the last tile is consumed
    // the whole tile in one round of copies; rows past `rows` zero-filled,
    // their rows never resolved
    if constexpr (Loader::kContiguous) {
      const size_t base = ld.row(bh, b, h, c0 + j0) * HD;
      for (int i = threadIdx.x; i < rowsW * kChunks; i += kThreads) {
        const int r = i / kChunks, cc = i % kChunks;
        const bool ok = r < rows;
        const size_t src = base + (size_t)(ok ? r : 0) * HD + cc * 8;
        cp_async16(Ks + r * kLd + cc * 8, ld.k + src, ok);
        cp_async16(Vs + r * kLd + cc * 8, ld.v + src, ok);
      }
    } else {
      // four positions' pool rows resolved before their copies
      const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
      for (int i0 = 0; i0 < kIters; i0 += 4) {
        size_t src[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + (i0 + u) * kR;
          src[u] = r < rows ? ld.row(bh, b, h, c0 + j0 + r) * HD : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + (i0 + u) * kR;
          if (r >= rowsW) continue;
          cp_async16(Ks + r * kLd + c * 8, ld.k + src[u] + c * 8, r < rows);
          cp_async16(Vs + r * kLd + c * 8, ld.v + src[u] + c * 8, r < rows);
        }
      }
    }
    cp_async_commit();
    // this thread's biases (positions kPosW warp + 8 jn + 2t + e % 2),
    // read while the tile lands; positions past `rows` score -inf
    float bv[kJn][2];
#pragma unroll
    for (int jn = 0; jn < kJn; ++jn)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pos = kPosW * warp + 8 * jn + 2 * t + u;
        bv[jn][u] = pos < rows ? ld.bias_at(b, c0 + j0 + pos) : -INFINITY;
      }
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T: this warp's kPosW positions (kJn 8-wide tiles), the HD /
    // 16 k-steps over hd in two chains
    float s[2][kJn][4];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int jn = 0; jn < kJn; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ch][jn][e] = 0.f;
    if (kPosW * warp < rows) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qs + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < kJn / 2; ++jp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Ks + (kPosW * warp + 16 * jp + (lane & 7) +
                                ((lane >> 4) << 3)) * kLd +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[kk & 1][2 * jp], qa, kb[0], kb[1]);
          mma_bf16(s[kk & 1][2 * jp + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // x 1/sqrt(hd), softcap, + bias; this warp's row max (4 lanes a row)
    float x[kJn][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < kJn; ++jn)
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
    for (int jn = 0; jn < kJn; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((x[jn][e] - ref[e >> 1]) * kLog2e);
        sum[e >> 1] += p;
        Ps[(g + 8 * (e >> 1)) * kLdP + kPosW * warp + 8 * jn + 2 * t +
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

// Set `kernel`'s shared memory and launch it: `splits` CTAs along x, one
// row (b, kv-head) each along y, the splits of a row one cluster.
template <int HD, int POS, class Kernel, class Loader>
cudaError_t launch(Kernel kernel, const void* q, const Loader& ld, void* out,
                   int B, int KV, int G, int splits, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, POS>();
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), ld,
                           static_cast<bf16*>(out), KV, G,
                           1.0f / sqrtf((float)HD), softcap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Whether the step takes these arguments: bf16, hd 64 (tiles of 64 or 128
// positions), 128 or 256 (tiles of 64), G at most 16, 1 to 8 splits, and
// at most 65535 rows.
inline bool takes(int dtype, int hd, int tile, int B, int KV, int G,
                  int splits) {
  return dtype == kBFloat16 &&
         (tile == 64 ? (hd == 64 || hd == 128 || hd == 256)
                     : tile == 128 && hd == 64) &&
         B > 0 && KV > 0 && G > 0 && G <= kRows && splits >= 1 &&
         splits <= kMaxSplits && (long)B * KV <= 65535;
}

}  // namespace step
}  // namespace repro_torch

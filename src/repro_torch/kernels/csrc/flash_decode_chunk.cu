// The chunk form of GQA decode attention over a dense KV cache, bf16 at
// hd 64, 128 and 256, on Hopper's tensor cores (sm_90a): the dense fused
// tick's prefill chunk, ck query tokens per row with a bias row each.
//
// Replaces, for the dense prefill continuation, the reference's loop of one
// TPU kernel call `flash_decode_bkhd` (`_decode_kernel`,
// src/repro/kernels/flash_decode.py) per chunk token
// (src/repro/models/attention.py:758-765). q (B,ck,KV,G,hd) attends to k/v
// (B,KV,C,hd) with an additive fp32 bias (B,ck,C): query row (j, g) of
// batch row b and KV head h takes the bias row (b, j). Every score is
// scaled by 1/sqrt(hd), then soft-capped (tanh, when softcap > 0), then
// biased, in that order; online softmax with fp32 (m, l, acc); l is
// floored at 1e-30. fp32, other head dims and the decode step
// (flash_decode.cu) keep the CUDA-core kernel; this file is its own
// library so that their binary stays as it was.
//
// What bounds it on this card: bytes, on the tensor cores' roofline. At
// tinyllama's fused tick (B=8, ck=16, KV=4, G=8, C=576, hd 64) and at
// gemma-2b's (KV=1, G=8, hd 256) the form does ~0.6 GFLOP of QK^T and PV
// on 4.7 MB of K/V, ~130 flops per byte, below the ~295 at which the bf16
// tensor cores become the limit; the bound is ~1 us (yi-6b's, KV=4, G=8,
// hd 128: twice both). The CUDA-core chunk form (fp32 FMAs, 16-32 query
// rows a CTA) took 0.18 ms at hd 64 and 0.17 at hd 256; in practice a
// launch's fixed latency, the latency of one tile's loads and the split
// combine's reads are the floor.
//
// What the design does about it (paged_decode.cu's tensor-core chunk form
// with a contiguous loader and a bias in place of lengths), one template
// instance per head dim HD:
// - One CTA is one warpgroup (128 threads) and 64 query rows of one
//   (b, kv-head), ordered j-major (row = j*G + g; at G = 8 eight chunk
//   tokens, at G = 5 rows span 13-14 tokens; a short last block's rows
//   past ck*G load zeros and store nothing). The 64 rows are the `wgmma`
//   M: QK^T runs as HD / 16 m64n64k16 steps, PV as one m64n{HD}k16 a
//   16-position step (wgmma.cuh), P from registers as hi + lo bf16 (one
//   bf16 P moves an output by up to 2^-9 of its size, past the 1e-2
//   check). A 64-row tile of Q, K or V is HD / 64 sub-tiles of 64 x 64
//   bf16 in the 128-byte swizzle; QK^T's k-steps walk the sub-tiles, and
//   V's descriptor steps over them by its leading byte offset.
// - The registers: the output accumulator is HD / 2 fp32 a thread (128 at
//   hd 256), beside 32 scores, their 32 biases and P's 32 halves. ptxas
//   (-Xptxas -v, sm_90a): 243 registers a thread at hd 256, 166 at 128,
//   128 at 64, no spill; one warpgroup a CTA keeps that under the 255 cap
//   without `setmaxnreg`. Shared memory is a Q tile and two-tile K and V
//   rings, 5 x HD x 128 bytes + 1 KB of alignment: 164,864 bytes at hd 256
//   (one CTA an SM), 82,944 at 128 (two), 41,984 at 64 (four).
// - K and V stream in 64-position tiles, each 64 rows of HD * 2
//   contiguous bytes of the (B,KV,C,hd) cache, through the double-buffered
//   swizzled ring with 16-byte `cp.async` copies (the next tile in flight
//   while this one is multiplied). Positions >= C (the ragged tail) are
//   zero-filled and scored -inf, so they weigh exactly 0 (the plain
//   version has no such positions).
// - Each accumulator row reads its chunk token's bias, row (R0 + r) / G,
//   straight from L2/L1 (__ldg), issued before the QK^T product so the
//   loads overlap it. A bias of -1e9 enters as in the plain version (s +
//   bias in fp32, then exp of the difference to the row max), so a row
//   whose every key is under -1e9 averages V as the plain version does.
// - The tiles of a (b, kv-head, row block) go to S CTAs in turn (split s
//   takes tiles s, s + S, ...; S is the wrapper's `splits` argument). At
//   hd 64, tinyllama's fused tick has 64 row blocks: S = 4 gives 256 CTAs
//   of 41 KB, about two per SM, and 9 tiles give 3, 2, 2, 2 per split. S
//   = 9 (one tile each, 576 CTAs) shortens the longest split to one tile
//   but more than doubles the partials the last CTA combines (9 x 16.5 KB
//   a block), and at 128 registers a thread four CTAs fit an SM, so 576
//   take two waves. Measured on an H100 (chip_smoke.py --ab's split
//   sweep), device time is lowest at S = 3-4: about 0.019 ms at S = 1,
//   0.014 at 2, 0.013 at 3 and 4, 0.015 at 6 and 0.020 at 9. gemma-2b's
//   fused tick (hd 256) has 16 row blocks (KV 1): S = 4 gives 64 CTAs,
//   one an SM, with 3, 2, 2, 2 tiles; the same sweep gives 0.036 ms at S
//   = 1, 0.028 at 2, 0.025 at 3, 0.022 at 4, 0.025 at 6, 0.022 at 8 and
//   0.034 at 9. yi-6b's (hd 128) has 64 row blocks: 0.025 at S = 1, 0.019
//   at 2, 3 and 4, 0.028 at 6, 0.033 at 8 and 0.035 at 9 (two waves from
//   6 on); S = 4 at every head dim (TC_SPLITS in flash_decode.py). Each
//   split writes its partial (acc, m, l) to the scratch workspace shared
//   with flash_decode and paged_decode, and the last to arrive combines
//   them (weights exp(m_s - M) / L) and sets its counter back to zero. The combine's L2 reads of the partials are
//   its cost (4 x 64 KB a block at hd 256), so it keeps up to 16 of its
//   16-byte reads in flight a thread (wgmma.cuh, wg_arrive_and_combine,
//   shared with paged_decode.cu). A split with no tile (C below 64 S)
//   writes m = -1e30, l = 0 and zeros: weight 0.
// - Rows are independent: a padded chunk query or an inert row reads stale
//   but finite cache entries and cannot reach another row's sums. The
//   cache must be finite under -1e9 biases: those positions enter the
//   product with a zero weight.
#include "wgmma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // one warpgroup
constexpr int kRows = 64;         // query rows per CTA (the wgmma M)
constexpr int kPos = 64;          // positions per K/V tile
constexpr int kMaxSplits = 64;

// The shapes of the HD instance: a 64-row tile of Q, K or V is HD / 64
// swizzled sub-tiles; Q | K ring (2) | V ring (2), plus room to align the
// base to 1024 bytes; one split's partial is acc (64, HD), m (64), l (64).
template <int HD>
struct Shape {
  static constexpr int kTile = HD / 64 * kWgTile;
  static constexpr size_t kSmemBytes = 5 * (size_t)kTile + 1024;
  static constexpr size_t kSplitFloats = (size_t)kRows * HD + 2 * kRows;
};

// Element offset of query row `row` (= j * G + g) of (b, h) in the
// (B, ck, KV, G, HD) layout of q and out.
template <int HD>
__device__ __forceinline__ size_t row_offset(int b, int h, int row, int ck,
                                             int KV, int G) {
  const int j = row / G, g = row % G;
  return ((((size_t)b * ck + j) * KV + h) * G + g) * HD;
}

// Start the copy of positions [t0, t0+64) of one (b, kv-head)'s cache rows
// `src` (C, HD) into a swizzled tile at shared address `dst`; positions at
// or past C are zero-filled and never read.
template <int HD>
__device__ __forceinline__ void issue_tile(uint32_t dst,
                                           const bf16* __restrict__ src,
                                           int t0, int C) {
  constexpr int kChunks = HD / 8;            // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kPos * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = t0 + r < C;
    cp_async16(dst + wg_tile_off(r, c),
               src + (size_t)(ok ? t0 + r : 0) * HD + c * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_chunk_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, float* __restrict__ partials,
                          int* __restrict__ arrivals, int ck, int KV, int G,
                          int C, float scale, float softcap) {
  extern __shared__ uint4 smem_raw[];
  constexpr int kTile = Shape<HD>::kTile;
  constexpr int kChunks = HD / 8;            // 16-byte chunks of a row
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + kTile;            // 2 tiles
  const uint32_t Vs = Ks + 2 * kTile;        // 2 tiles

  const int split = blockIdx.x, splits = gridDim.x;
  const int rb = blockIdx.y, n_rb = gridDim.y;
  const int bh = blockIdx.z, b = bh / KV, h = bh % KV;
  const int R0 = rb * kRows, nr = min(kRows, ck * G - R0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const bf16* kp = k + (size_t)bh * C * HD;
  const bf16* vp = v + (size_t)bh * C * HD;
  // the bias rows of this thread's two accumulator rows (the padding rows
  // past ck*G take the last token's: their outputs are never stored)
  const float* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = min((R0 + warp * 16 + g + r * 8) / G, ck - 1);
    brow[r] = bias + ((size_t)b * ck + j) * C;
  }
  // this split's tiles: split, split + splits, ... below C
  const int n_tiles = (C + kPos - 1) / kPos;
  const int mine = n_tiles > split ? (n_tiles - 1 - split) / splits + 1 : 0;

  if (mine > 0) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r < nr;
      cp_async16(Qs + wg_tile_off(r, c),
                 q + (ok ? row_offset<HD>(b, h, R0 + r, ck, KV, G) : 0) +
                     c * 8,
                 ok);
    }
    issue_tile<HD>(Ks, kp, split * kPos, C);
    issue_tile<HD>(Vs, vp, split * kPos, C);
    cp_async_commit();
  }

  // accumulator element 4n + e: row warp*16 + g + (e / 2) * 8, column
  // 8n + 2t + e % 2 (the mma.sync layout, per 8-column block n)
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the biased scores
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = 0; i < mine; ++i) {
    const int kt = split + i * splits, buf = i & 1;
    const int t0 = kt * kPos;
    if (i + 1 < mine) {                // prefetch the next tile
      const int t1 = t0 + splits * kPos;
      issue_tile<HD>(Ks + (buf ^ 1) * kTile, kp, t1, C);
      issue_tile<HD>(Vs + (buf ^ 1) * kTile, vp, t1, C);
      cp_async_commit();
    }
    // this tile's biases of the thread's 32 scores, read while the tile
    // lands and QK^T runs; positions past C score -inf
    float bv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = t0 + (e >> 2) * 8 + 2 * t + (e & 1);
      bv[e] = col < C ? __ldg(brow[(e >> 1) & 1] + col) : -INFINITY;
    }
    if (i + 1 < mine)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    // cp.async wrote the tiles through the generic proxy; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t Kt = Ks + buf * kTile, Vt = Vs + buf * kTile;

    // S = Q K^T (64 rows x 64 positions): HD / 16 k-steps of 16 along hd,
    // four in each 64-column sub-tile
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t at = (kk / 4) * kWgTile + (kk % 4) * 32;
      wg_ss(s, wg_desc(Qs + at), wg_desc(Kt + at), kk > 0);
    }
    wg_commit();
    wg_wait0();
    wg_fence_regs(s);

    // x 1/sqrt(hd), softcap, + bias; online softmax per row (4 lanes
    // share a row)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * scale;
      if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
      x += bv[e];
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float ref[2];                      // the new max (0 while none is finite)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      ref[r] = m_new == -INFINITY ? 0.f : m_new;
      // the difference first: exact for scores near -1e9, as in the
      // plain version's softmax
      const float alpha = ex2((m[r] - ref[r]) * kLog2e);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 2 * r] *= alpha;
        o[4 * n + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = ex2((s[e] - ref[(e >> 1) & 1]) * kLog2e);
      s[e] = p;
      l[(e >> 1) & 1] += p;
    }

    // O += P V (one m64nHDk16 a k-step), P as hi + lo bf16 A fragments;
    // k-step kk covers positions 16kk .. 16kk+15: 16 rows of V, 2048 bytes
    // into each sub-tile, the next 64 columns of hd kWgTile bytes on
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p0 = s + 8 * kk;      // 8-column block 2kk
      const float* p1 = s + 8 * kk + 4;  // 8-column block 2kk + 1
      split_bf16(p0[0], p0[1], ph[kk][0], pl[kk][0]);
      split_bf16(p0[2], p0[3], ph[kk][1], pl[kk][1]);
      split_bf16(p1[0], p1[1], ph[kk][2], pl[kk][2]);
      split_bf16(p1[2], p1[3], ph[kk][3], pl[kk][3]);
    }
    constexpr uint32_t lbo = HD > 64 ? kWgTile : 1024;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs(o, ph[kk], wg_desc(Vt + kk * 2048, lbo));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs(o, pl[kk], wg_desc(Vt + kk * 2048, lbo));
    wg_commit();
    wg_wait0();
    wg_fence_regs(o);
    __syncthreads();                   // this buffer is refilled next round
  }

  // publish this split's partial (all 64 rows; the combine reads nr)
  constexpr size_t kSplitFloats = Shape<HD>::kSplitFloats;
  float* pb = partials + ((size_t)bh * n_rb + rb) * splits * kSplitFloats;
  float* my = pb + (size_t)split * kSplitFloats;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(my + row * HD + 8 * n + 2 * t) =
          make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    if (t == 0) {
      my[kRows * HD + row] = m[r] == -INFINITY ? kNegInf : m[r];
      my[kRows * HD + kRows + row] = l[r];
    }
  }
  __threadfence();
  wg_arrive_and_combine<HD>(pb, arrivals + (size_t)bh * n_rb + rb, splits,
                            nr, kLog2e, reinterpret_cast<float*>(smem_raw),
                            out, b, h, R0, ck, KV, G);
}

// Launch the HD instance: `splits` CTAs per (b, kv-head, block of 64
// query rows).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* partials,
                   void* arrivals, int B, int KV, int G, int C, int ck,
                   int n_rb, int splits, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Shape<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_chunk_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (unsigned)n_rb, B * KV);
  flash_decode_chunk_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(partials),
      static_cast<int*>(arrivals), ck, KV, G, C, 1.0f / sqrtf((float)HD),
      softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, ck, KV, G, hd) bf16, k and v (B, KV, C, hd) bf16, bias
// (B, ck, C) fp32; `splits` CTAs per (b, kv-head, block of 64 query rows)
// (flash_decode_launch's arguments, with `splits` where it takes `rows`).
// With n = ceil(ck * G / 64) row blocks, `partials` holds
// B*KV*n*splits*(64*hd + 2*64) floats and `arrivals` B*KV*n ints, zero
// before the launch and left at zero after it. `dtype` must be bf16 and
// `hd` 64, 128 or 256: what this kernel takes.
extern "C" int flash_decode_chunk_launch(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, void* partials,
                                         void* arrivals, int B, int KV,
                                         int G, int C, int hd, int ck,
                                         int splits, float softcap, int dtype,
                                         void* stream) {
  using namespace repro_torch;
  const long n_rb = G > 0 ? ((long)ck * G + kRows - 1) / kRows : 0;
  if (dtype != kBFloat16 || B <= 0 || ck <= 0 || KV <= 0 || G <= 0 ||
      C <= 0 || splits < 1 || splits > kMaxSplits || (long)B * KV > 65535 ||
      n_rb > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch<64>(q, k, v, bias, out, partials, arrivals, B, KV,
                             G, C, ck, (int)n_rb, splits, softcap, s);
    case 128:
      return (int)launch<128>(q, k, v, bias, out, partials, arrivals, B, KV,
                              G, C, ck, (int)n_rb, splits, softcap, s);
    case 256:
      return (int)launch<256>(q, k, v, bias, out, partials, arrivals, B, KV,
                              G, C, ck, (int)n_rb, splits, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

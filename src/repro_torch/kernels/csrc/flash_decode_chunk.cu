// The chunk form of GQA decode attention over a dense KV cache, bf16 at
// hd 64, on Hopper's tensor cores (sm_90a): the dense fused tick's prefill
// chunk, ck query tokens per row with a bias row each.
//
// Replaces, for the dense prefill continuation, the reference's loop of one
// TPU kernel call `flash_decode_bkhd` (`_decode_kernel`,
// src/repro/kernels/flash_decode.py) per chunk token
// (src/repro/models/attention.py:758-765). q (B,ck,KV,G,64) attends to k/v
// (B,KV,C,64) with an additive fp32 bias (B,ck,C): query row (j, g) of
// batch row b and KV head h takes the bias row (b, j). Every score is
// scaled by 1/sqrt(hd), then soft-capped (tanh, when softcap > 0), then
// biased, in that order; online softmax with fp32 (m, l, acc); l is
// floored at 1e-30. fp32, hd 128 and the decode step (flash_decode.cu)
// keep the CUDA-core kernel; this file is its own library so that their
// binary stays as it was.
//
// What bounds it on this card: bytes, on the tensor cores' roofline. At
// the serve shape (B=8, ck=16, KV=4, G=8, C=576) the form does ~0.6 GFLOP
// of QK^T and PV on 4.7 MB of K/V, ~130 flops per byte, below the ~295 at
// which the bf16 tensor cores become the limit; the bound is ~1 us. The
// CUDA-core chunk form (fp32 FMAs, one CTA per SM at 127.7 KB of shared
// memory) took 0.18 ms; in practice a launch's fixed latency and the
// latency of one tile's loads are the floor.
//
// What the design does about it (paged_decode.cu's tensor-core chunk form
// with a contiguous loader and a bias in place of lengths):
// - One CTA is one warpgroup (128 threads) and 64 query rows of one
//   (b, kv-head), ordered j-major (row = j*G + g; at G = 8 eight chunk
//   tokens, at G = 5 rows span 13-14 tokens; a short last block's rows
//   past ck*G load zeros and store nothing). The 64 rows are the `wgmma`
//   M: QK^T and PV run as m64n64k16 from 128-byte-swizzled tiles
//   (wgmma.cuh), P from registers as hi + lo bf16 (one bf16 P moves an
//   output by up to 2^-9 of its size, past the 1e-2 check).
// - K and V stream in 64-position tiles, each 64 rows of 128 contiguous
//   bytes of the (B,KV,C,hd) cache, through a double-buffered swizzled
//   ring with 16-byte `cp.async` copies (the next tile in flight while this
//   one is multiplied). Positions >= C (the ragged tail) are zero-filled
//   and scored -inf, so they weigh exactly 0 (the plain version has no
//   such positions).
// - Each accumulator row reads its chunk token's bias, row (R0 + r) / G,
//   straight from L2/L1 (__ldg), issued before the QK^T product so the
//   loads overlap it. A bias of -1e9 enters as in the plain version (s +
//   bias in fp32, then exp of the difference to the row max), so a row
//   whose every key is under -1e9 averages V as the plain version does.
// - The tiles of a (b, kv-head, row block) go to S = 4 CTAs in turn
//   (split s takes tiles s, s + S, ...): at the serve shape 64 row blocks
//   x 4 = 256 CTAs of 41 KB of shared memory, about two per SM on the 132
//   SMs, and 9 tiles give 3, 2, 2, 2 per split. S = 9 (one tile each,
//   576 CTAs) shortens the longest split to one tile but more than
//   doubles the partials the last CTA combines (9 x 16.5 KB a block), and
//   at 162 registers a thread three CTAs fit an SM, so 576 take two
//   waves. Measured on an H100 (chip_smoke.py --ab's split sweep), device
//   time is lowest at S = 4: about 0.020 ms at S = 1, 0.017 at 2, 0.014
//   at 4, 0.018 at 6 and 0.023 at 9. S is the wrapper's `splits`
//   argument. Each split writes its partial (acc, m, l) to the scratch
//   workspace shared with flash_decode and paged_decode, and the last to
//   arrive combines them (weights exp(m_s - M) / L) and sets its counter
//   back to zero. A split with no tile (C below 64 S) writes m = -1e30,
//   l = 0 and zeros: weight 0.
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
constexpr int kHd = 64;
constexpr int kMaxSplits = 64;

// Q | K ring (2) | V ring (2), plus room to align the base to 1024 bytes
constexpr size_t kSmemBytes = 5 * kWgTile + 1024;

// Floats of one split's partial: acc (64, 64), m (64), l (64).
constexpr size_t kSplitFloats = (size_t)kRows * kHd + 2 * kRows;

// Element offset of query row `row` (= j * G + g) of (b, h) in the
// (B, ck, KV, G, hd) layout of q and out.
__device__ __forceinline__ size_t row_offset(int b, int h, int row, int ck,
                                             int KV, int G) {
  const int j = row / G, g = row % G;
  return ((((size_t)b * ck + j) * KV + h) * G + g) * kHd;
}

// Start the copy of positions [t0, t0+64) of one (b, kv-head)'s cache rows
// `src` (C, 64) into a swizzled tile at shared address `dst`; positions at
// or past C are zero-filled and never read.
__device__ __forceinline__ void issue_tile(uint32_t dst,
                                           const bf16* __restrict__ src,
                                           int t0, int C) {
  for (int i = threadIdx.x; i < kPos * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    const bool ok = t0 + r < C;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + (size_t)(ok ? t0 + r : 0) * kHd + c * 8, ok);
  }
}

// This CTA has written its partial (every thread fenced its own stores);
// arrive on the block's counter, and if last, combine the `splits`
// partials at `pb` into the output rows R0 .. R0+nr-1 and reset the
// counter. `w_s` is shared memory for splits * 64 floats.
__device__ void arrive_and_combine(const float* pb, int* counter, int splits,
                                   int nr, float* w_s, bf16* __restrict__ out,
                                   int b, int h, int R0, int ck, int KV,
                                   int G) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  constexpr size_t m_at = (size_t)kRows * kHd, l_at = m_at + kRows;
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, __ldcg(pb + s * kSplitFloats + m_at + r));
    for (int s = 0; s < splits; ++s) {
      const float w =
          ex2((__ldcg(pb + s * kSplitFloats + m_at + r) - M) * kLog2e);
      w_s[s * kRows + r] = w;
      L = fmaf(__ldcg(pb + s * kSplitFloats + l_at + r), w, L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < splits; ++s) w_s[s * kRows + r] *= inv;
  }
  __syncthreads();
  // four columns a thread: 16-byte partial reads, 8-byte output stores
  for (int i = threadIdx.x; i < nr * (kHd / 4); i += kThreads) {
    const int r = i / (kHd / 4), d = 4 * (i % (kHd / 4));
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(pb + s * kSplitFloats + r * kHd + d));
      const float w = w_s[s * kRows + r];
      O.x = fmaf(a.x, w, O.x);
      O.y = fmaf(a.y, w, O.y);
      O.z = fmaf(a.z, w, O.z);
      O.w = fmaf(a.w, w, O.w);
    }
    uint2 packed;
    packed.x = pack_bf16(O.x, O.y);
    packed.y = pack_bf16(O.z, O.w);
    *reinterpret_cast<uint2*>(out + row_offset(b, h, R0 + r, ck, KV, G) + d) =
        packed;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

__global__ void __launch_bounds__(kThreads)
flash_decode_chunk_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, float* __restrict__ partials,
                          int* __restrict__ arrivals, int ck, int KV, int G,
                          int C, float scale, float softcap) {
  extern __shared__ uint4 smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + kWgTile;          // 2 tiles
  const uint32_t Vs = Ks + 2 * kWgTile;      // 2 tiles

  const int split = blockIdx.x, splits = gridDim.x;
  const int rb = blockIdx.y, n_rb = gridDim.y;
  const int bh = blockIdx.z, b = bh / KV, h = bh % KV;
  const int R0 = rb * kRows, nr = min(kRows, ck * G - R0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const bf16* kp = k + (size_t)bh * C * kHd;
  const bf16* vp = v + (size_t)bh * C * kHd;
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
    for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
      const int r = i / 8, c = i % 8;
      const bool ok = r < nr;
      cp_async16(Qs + r * 128 + ((c ^ (r & 7)) << 4),
                 q + (ok ? row_offset(b, h, R0 + r, ck, KV, G) : 0) + c * 8,
                 ok);
    }
    issue_tile(Ks, kp, split * kPos, C);
    issue_tile(Vs, vp, split * kPos, C);
    cp_async_commit();
  }

  // accumulator element 4n + e: row warp*16 + g + (e / 2) * 8, column
  // 8n + 2t + e % 2 (the mma.sync layout, per 8-column block n)
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the biased scores
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int i = 0; i < mine; ++i) {
    const int kt = split + i * splits, buf = i & 1;
    const int t0 = kt * kPos;
    if (i + 1 < mine) {                // prefetch the next tile
      const int t1 = t0 + splits * kPos;
      issue_tile(Ks + (buf ^ 1) * kWgTile, kp, t1, C);
      issue_tile(Vs + (buf ^ 1) * kWgTile, vp, t1, C);
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
    const uint32_t Kt = Ks + buf * kWgTile, Vt = Vs + buf * kWgTile;

    // S = Q K^T (64 rows x 64 positions): four k-steps of 16 along hd
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wg_ss(s, wg_desc(Qs + kk * 32), wg_desc(Kt + kk * 32), kk > 0);
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
      for (int n = 0; n < 8; ++n) {
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

    // O += P V, P as hi + lo bf16 A fragments; k-step kk covers positions
    // 16kk .. 16kk+15: 16 rows of V, 2048 bytes
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
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg_rs(o, ph[kk], wg_desc(Vt + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg_rs(o, pl[kk], wg_desc(Vt + kk * 2048));
    wg_commit();
    wg_wait0();
    wg_fence_regs(o);
    __syncthreads();                   // this buffer is refilled next round
  }

  // publish this split's partial (all 64 rows; the combine reads nr)
  float* pb = partials + ((size_t)bh * n_rb + rb) * splits * kSplitFloats;
  float* my = pb + (size_t)split * kSplitFloats;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(my + row * kHd + 8 * n + 2 * t) =
          make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
    if (t == 0) {
      my[kRows * kHd + row] = m[r] == -INFINITY ? kNegInf : m[r];
      my[kRows * kHd + kRows + row] = l[r];
    }
  }
  __threadfence();
  arrive_and_combine(pb, arrivals + (size_t)bh * n_rb + rb, splits, nr,
                     reinterpret_cast<float*>(smem_raw), out, b, h, R0, ck,
                     KV, G);
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, ck, KV, G, 64) bf16, k and v (B, KV, C, 64) bf16, bias
// (B, ck, C) fp32; `splits` CTAs per (b, kv-head, block of 64 query rows)
// (flash_decode_launch's arguments, with `splits` where it takes `rows`).
// With n = ceil(ck * G / 64) row blocks, `partials` holds
// B*KV*n*splits*(64*64 + 2*64) floats and `arrivals` B*KV*n ints, zero
// before the launch and left at zero after it. `dtype` must be bf16 and
// `hd` 64: what this kernel takes.
extern "C" int flash_decode_chunk_launch(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, void* partials,
                                         void* arrivals, int B, int KV,
                                         int G, int C, int hd, int ck,
                                         int splits, float softcap, int dtype,
                                         void* stream) {
  using namespace repro_torch;
  const long n_rb = G > 0 ? ((long)ck * G + kRows - 1) / kRows : 0;
  if (dtype != kBFloat16 || hd != kHd || B <= 0 || ck <= 0 || KV <= 0 ||
      G <= 0 || C <= 0 || splits < 1 || splits > kMaxSplits ||
      (long)B * KV > 65535 || n_rb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, (unsigned)n_rb, B * KV);
  flash_decode_chunk_kernel<<<grid, kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(partials),
      static_cast<int*>(arrivals), ck, KV, G, C, 1.0f / sqrtf((float)kHd),
      softcap);
  return (int)cudaGetLastError();
}

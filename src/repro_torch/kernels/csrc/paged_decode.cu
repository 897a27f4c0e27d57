// GQA decode attention through a block table into a shared KV page pool, for
// Hopper (sm_90a), in two forms that share one launch interface.
//
// Replaces the TPU kernel `paged_flash_decode_bkhd` (`_paged_decode_kernel`)
// of src/repro/kernels/paged/decode.py and, for the prefill continuation,
// the reference's loop of one such call per chunk token
// (src/repro/models/attention.py:813-818). Query rows (j, g) of a batch row
// b and KV head h attend to the pages `tables[b, t / ps]` (offset t % ps) of
// the k/v pools (KV,P,ps,hd) over positions t < lengths[b, j] (capped at
// n_pages * ps); q and out are (B, ck, KV, G, hd), lengths (B, ck): the
// single-query form is ck = 1. Scores are scaled by 1/sqrt(hd), then
// soft-capped (tanh, when softcap > 0); online softmax with fp32 (m, l,
// acc); l is floored at 1e-30, so a length of 0 gives zeros. Only the table
// entries below the largest length of a CTA's rows are read, and no
// position at or past it, so the kernel does not depend on the TPU kernel's
// trash-page convention and poisoned (NaN) pages past every length cannot
// reach an output.
//
// What bounds it on this card: bytes, in both forms. The decode step reads
// the live pages of every row once (at most 4.7 MB at the serve path's B=8,
// KV=4, 36 pages of 16, hd=64, bf16) for ~2 flops per byte. The fused
// tick's chunk (ck = 16 tokens, G = 8) reads the same pages for 128 query
// rows per (b, kv-head): ~0.5 GFLOP against ~4.7 MB, ~110 flops per byte,
// still below the ~295 at which the bf16 tensor cores become the limit, but
// far above what the CUDA cores sustain (gemma-2b's fused tick, one KV head
// of hd 256, has the same bytes and flops; yi-6b's, four of hd 128, twice
// both); one single-query call per chunk token would read every page ck
// times.
//
// What the design does about it. Both forms split each (b, kv-head, block of
// query rows) over several CTAs along the positions (one launch); each CTA
// writes its partial (acc, m, l) to a scratch workspace and arrives on a
// counter; the last to arrive combines the partials (weights 2^(m_s - M) /
// L) and sets the counter back to zero for the next launch (flash_decode's
// design: a thread-block cluster was slower there). A split with no live
// position has m = -1e30, l = 0 and zeros, so it adds nothing.
//
// - Chunk form, bf16 at hd 64, 128 and 256 (the fused tick): the ck*G
//   query rows of a (b, kv-head), ordered j-major, in blocks of 64 (one
//   `wgmma` M); QK^T as HD / 16 m64n64k16 steps and PV as one m64n{HD}k16
//   a 16-position step from 128-byte-swizzled shared memory (HD / 64
//   sub-tiles of 64 x 64 a tile), P from registers as hi + lo bf16 (one
//   bf16 P moves an output by up to 2^-9 of its size, past the 1e-2 check
//   at |out| in [2, 4)), the machinery of flash_decode_chunk.cu
//   (wgmma.cuh), one template instance per head dim. The one difference is
//   the tile loader: a 64-position K/V tile is gathered with `cp.async`
//   from the pages the row's table names (4 pages at ps 16, 8 at ps 8;
//   a page row is HD * 2 contiguous bytes), double-buffered, once per (b,
//   kv-head, row block) for all ck chunk tokens; a thread reads the table
//   entries of four of its rows before issuing any of their copies, one
//   entry serving K and V. The tiles below the
//   block's largest length go to the splits in turn (split s takes tiles
//   s, s + S, ...: 9 tiles of a 576-position table over S = 4 splits is 3,
//   2, 2, 2); the per-row mask t < lengths[b, j] is evaluated only on
//   tiles that reach past the block's smallest length. A row past its own
//   length multiplies V by a zero probability, so positions between a
//   row's length and its block's largest length must hold finite V (in the
//   engine they are the chunk's own positions, written before the call, or
//   earlier contents of the row's pages). ptxas (-Xptxas -v, sm_90a): 230
//   registers a thread at hd 256, 128 at 128, 108 at 64, no spill; shared
//   memory 164,864 bytes at hd 256 (one CTA an SM), 82,944 at 128, 41,984
//   at 64. The last split's combine is wg_arrive_and_combine (wgmma.cuh,
//   shared with flash_decode_chunk.cu), with up to 16 partial reads in
//   flight a thread. Splits (chip_smoke.py --ab's sweep, device ms on an
//   H100 at 700 W): at gemma-2b's fused tick (hd 256, 16 row blocks)
//   0.047 at S = 1, 0.035 at 2, 0.033 at 3, 0.027 at 4, 0.032 at 6, 0.030
//   at 8, 0.037 at 9; at yi-6b's (hd 128, 64 row blocks) 0.030 at 1,
//   0.023 at 2, 0.024 at 3 and 4, 0.038 at 6, 0.041 at 8, 0.044 at 9 (2
//   is ~1 us faster there); S = 4 at every head dim, one count for the
//   route (CHUNK_SPLITS in paged_decode.py).
// - Everything else (the single-query decode step, fp32, other head
//   dims):
//   fp32 FMAs on the CUDA cores (decode does ~2 flops per byte). A CTA keeps
//   its block of query rows resident in shared memory as fp32 and streams
//   its contiguous slice of positions through a double-buffered `cp.async`
//   ring (the next tile is in flight while this one is scored and summed);
//   scores spread over all threads as (row, position) pairs, P.V as (row,
//   hd column) outputs. Each row stops at its own length, so no masked
//   position enters its sums. The decode step splits each row's live
//   positions over 8 CTAs: 256 CTAs at the serve shape, where one CTA per
//   (b, kv-head) left 100 of the 132 SMs idle and loaded, then computed,
//   with no overlap.
#include "wgmma.cuh"

namespace repro_torch {
namespace {

// Floats of one split's partial for a block of RB rows: acc (RB, hd), then
// m (RB) in log2 units (-1e30 where no position was live), then l (RB).
__host__ __device__ inline size_t split_floats(int RB, int hd) {
  return (size_t)RB * hd + 2 * (size_t)RB;
}

// Element offset of query row `row` (= j * G + g) of (b, h) in the
// (B, ck, KV, G, hd) layout of q and out.
__device__ __forceinline__ size_t row_offset(int b, int h, int row, int ck,
                                             int KV, int G, int hd) {
  const int j = row / G, g = row % G;
  return ((((size_t)b * ck + j) * KV + h) * G + g) * hd;
}

// This CTA has written its partial (every thread fenced its own stores);
// arrive on the block's counter, and if last, combine the `splits` partials
// at `pb` into the output rows R0 .. R0+nr-1 and reset the counter. `w_s`
// is shared memory for splits * RB floats.
template <typename T>
__device__ void arrive_and_combine(const float* pb, int* counter, int splits,
                                   int RB, int nr, int hd, float* w_s,
                                   T* __restrict__ out, int b, int h, int R0,
                                   int ck, int KV, int G) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const size_t sf = split_floats(RB, hd);
  const size_t m_at = (size_t)RB * hd, l_at = m_at + RB;
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, __ldcg(pb + s * sf + m_at + r));
    for (int s = 0; s < splits; ++s) {
      const float w = exp2f(__ldcg(pb + s * sf + m_at + r) - M);
      w_s[s * RB + r] = w;
      L = fmaf(__ldcg(pb + s * sf + l_at + r), w, L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < splits; ++s) w_s[s * RB + r] *= inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    float O = 0.f;
    for (int s = 0; s < splits; ++s)
      O = fmaf(__ldcg(pb + s * sf + e), w_s[s * RB + r], O);
    store(out + row_offset(b, h, R0 + r, ck, KV, G, hd) + d, O);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// ============================================================ CUDA cores

constexpr int kSimtThreads = 256;
constexpr int kMaxAcc = 16;   // accumulators per thread: RB*hd <= 4096

// Elements per 16-byte vector: K rows are padded by one vector, so lanes
// that read consecutive rows with 16-byte loads hit distinct banks.
template <typename T>
__host__ __device__ constexpr int kvec() { return 16 / sizeof(T); }

// Positions per shared-memory tile: 128 in bf16 (a decode split's 72
// positions at the serve shape are one tile), 64 in fp32; half that above
// hd 128, so the K/V ring does not grow with hd (gemma-2b's hd 256: 64
// positions in bf16, 133 KB of ring, where 128 would need 266 KB).
template <typename T>
constexpr int tile_rows(int hd) {
  return (sizeof(T) == 2 ? 128 : 64) / (hd > 128 ? 2 : 1);
}

// Shared layout: K ring (2, TR, hd + pad) T | V ring (2, TR, hd) T | q (RB,
// hd) | p (RB, TR) | m, l, alpha (RB) fp32 | lengths (RB) int.
template <typename T>
size_t simt_smem_bytes(int RB, int hd) {
  const int TR = tile_rows<T>(hd);
  return sizeof(T) * 2 * TR * ((size_t)(hd + kvec<T>()) + hd) +
         sizeof(float) * ((size_t)RB * hd + (size_t)RB * TR + 4 * (size_t)RB);
}

// Start the copy of positions p0 .. p0+rows-1 of one row (K rows land with
// stride ldk); position p lives at offset p % ps of page trow[p / ps].
template <typename T>
__device__ __forceinline__ void issue_positions(
    T* ks, T* vs, int ldk, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ trow, int p0, int rows, int ps, int hd) {
  constexpr int V = kvec<T>();
  const int per_row = hd / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kSimtThreads) {
    const int r = i / per_row, c = (i % per_row) * V;
    const int p = p0 + r;
    const size_t src = ((size_t)__ldg(trow + p / ps) * ps + p % ps) * hd + c;
    cp_async16(ks + r * ldk + c, kp + src);
    cp_async16(vs + r * hd + c, vp + src);
  }
}

template <typename T, int TR>
__global__ void __launch_bounds__(kSimtThreads)
paged_decode_simt_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                         const T* __restrict__ vpool,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         float* __restrict__ partials,
                         int* __restrict__ arrivals, int ck, int KV, int G,
                         int P, int ps, int hd, int n_pages, int tstride,
                         int RB, float scale, float softcap) {
  constexpr int V = kvec<T>();
  extern __shared__ uint4 smem_raw[];
  __shared__ int lmax_s;
  const int ldk = hd + V;
  T* ks = reinterpret_cast<T*>(smem_raw);       // (2, TR, ldk)
  T* vs = ks + 2 * TR * ldk;                     // (2, TR, hd)
  float* qs = reinterpret_cast<float*>(vs + 2 * TR * hd);  // (RB, hd)
  float* pr_s = qs + RB * hd;                    // (RB, TR) scores, probs
  float* m_s = pr_s + RB * TR;                   // (RB,) running max
  float* l_s = m_s + RB;                         // (RB,) running sum
  float* a_s = l_s + RB;                         // (RB,) this tile's rescale
  int* len_s = reinterpret_cast<int*>(a_s + RB);  // (RB,) live positions

  const int split = blockIdx.x, splits = gridDim.x;
  const int rb = blockIdx.y, n_rb = gridDim.y;
  const int bh = blockIdx.z, b = bh / KV, h = bh % KV;
  const int R0 = rb * RB, nr = min(RB, ck * G - R0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = kSimtThreads / 32;
  const T* kp = kpool + (size_t)h * P * ps * hd;
  const T* vp = vpool + (size_t)h * P * ps * hd;
  const int* trow = tables + (size_t)b * tstride;

  if (tid == 0) lmax_s = 0;
  __syncthreads();
  for (int r = tid; r < nr; r += kSimtThreads) {
    const int len = max(0, min(lengths[(size_t)b * ck + (R0 + r) / G],
                               n_pages * ps));
    len_s[r] = len;
    atomicMax(&lmax_s, len);
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // this split's slice of the block's live positions [0, lmax)
  const int lmax = lmax_s;
  const int chunk = (lmax + splits - 1) / splits;
  const int c0 = min(lmax, split * chunk), n = min(lmax, c0 + chunk) - c0;
  const int n_tiles = (n + TR - 1) / TR;
  if (n_tiles > 0) {
    issue_positions(ks, vs, ldk, kp, vp, trow, c0, min(TR, n), ps, hd);
    cp_async_commit();
  }
  for (int i = tid; i < nr * hd; i += kSimtThreads)
    qs[i] = to_float(q[row_offset(b, h, R0 + i / hd, ck, KV, G, hd) + i % hd]);
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * TR, p0 = c0 + j0;
    const int rows = min(TR, n - j0);
    const T* kt = ks + (t & 1) * TR * ldk;
    const T* vt = vs + (t & 1) * TR * hd;
    if (t + 1 < n_tiles) {             // prefetch the next tile
      const int nb = (t + 1) & 1;
      issue_positions(ks + nb * TR * ldk, vs + nb * TR * hd, ldk, kp, vp,
                      trow, p0 + TR, min(TR, n - j0 - TR), ps, hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scores for every (r, j) of the tile below the row's length:
    // x 1/sqrt(hd), then softcap; a warp's lanes take consecutive j
    for (int e = tid; e < nr * rows; e += kSimtThreads) {
      const int r = e / rows, j = e % rows;
      if (p0 + j >= len_s[r]) continue;
      const float* qr = qs + r * hd;
      const T* kr = kt + j * ldk;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: more in flight
      for (int d = 0; d < hd; d += V) {
        float kv[V];
        load_vec(kr + d, kv);
#pragma unroll
        for (int u = 0; u < V; ++u)
          dot[u & 3] = fmaf(qr[d + u], kv[u], dot[u & 3]);
      }
      float s = (dot[0] + dot[1] + (dot[2] + dot[3])) * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      pr_s[r * TR + j] = s;
    }
    __syncthreads();
    // online softmax over the row's live positions: one warp per row
    for (int r = warp; r < nr; r += nwarps) {
      float* pr = pr_s + r * TR;
      const int live = max(0, min(rows, len_s[r] - p0));
      float mx = kNegInf;
      for (int j = lane; j < live; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < live; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc(r, d) = acc * alpha(r) + sum over live j of p(r, j) v(j, d)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kSimtThreads;
      if (e < nr * hd) {
        const int r = e / hd, d = e % hd;
        const int live = max(0, min(rows, len_s[r] - p0));
        const float* pr = pr_s + r * TR;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        int j = 0;
        for (; j + 3 < live; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pv[u] = fmaf(pr[j + u], to_float(vt[(j + u) * hd + d]), pv[u]);
        }
        for (; j < live; ++j)
          pv[0] = fmaf(pr[j], to_float(vt[j * hd + d]), pv[0]);
        acc[i] = acc[i] * a_s[r] + ((pv[0] + pv[1]) + (pv[2] + pv[3]));
      }
    }
    __syncthreads();                   // this buffer is refilled next round
  }

  // publish this split's partial; the last split to arrive combines
  float* pb = partials + ((size_t)bh * n_rb + rb) * splits *
                             split_floats(RB, hd);
  float* mine = pb + (size_t)split * split_floats(RB, hd);
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kSimtThreads;
    if (e < nr * hd) mine[e] = acc[i];
  }
  for (int r = tid; r < nr; r += kSimtThreads) {
    mine[RB * hd + r] = m_s[r] > kNegInf ? m_s[r] * kLog2e : kNegInf;
    mine[RB * hd + RB + r] = l_s[r];
  }
  __threadfence();
  arrive_and_combine(pb, arrivals + (size_t)bh * n_rb + rb, splits, RB, nr,
                     hd, pr_s, out, b, h, R0, ck, KV, G);
}

// ============================================================ tensor cores

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kWgRows = 64;       // query rows per CTA (the wgmma M)
constexpr int kWgPos = 64;        // positions per K/V tile

// A 64-row tile of Q, K or V at head dim HD is HD / 64 swizzled
// sub-tiles; shared memory holds Q | K ring (2) | V ring (2), plus room to
// align the base to 1024 bytes.
template <int HD>
__host__ __device__ constexpr int wg_tile_bytes() {
  return HD / 64 * kWgTile;
}
template <int HD>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return 5 * (size_t)wg_tile_bytes<HD>() + 1024;
}

// Start the copies of positions [t0, t0+64) of one row's pages into the
// swizzled K and V tiles at shared addresses `kdst` and `vdst`; positions
// at or past `lmax` are zero-filled and their table entries never read. A
// thread's 16-byte chunks sit in rows r0, r0 + R, ... (R = 128 / (HD / 8)
// rows a pass), and the table entries of four rows are read before any of
// their copies is issued, one entry serving K and V.
template <int HD>
__device__ __forceinline__ void issue_page_tiles(
    uint32_t kdst, uint32_t vdst, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ trow,
    int t0, int lmax, int ps) {
  constexpr int kChunks = HD / 8, kR = kWgThreads / kChunks;
  constexpr int kPasses = kWgPos / kR;
  static_assert(kWgThreads % kChunks == 0 && kPasses % 4 == 0, "tile");
  const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
  for (int q = 0; q < kPasses; q += 4) {
    int row[4];                        // pool row of each position, or -1
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = t0 + r0 + (q + u) * kR;
      row[u] = p < lmax ? __ldg(trow + p / ps) * ps + p % ps : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t at = wg_tile_off(r0 + (q + u) * kR, c);
      const size_t src = (size_t)max(row[u], 0) * HD + c * 8;
      cp_async16(kdst + at, kpool + src, row[u] >= 0);
      cp_async16(vdst + at, vpool + src, row[u] >= 0);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
paged_chunk_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kpool,
                         const __nv_bfloat16* __restrict__ vpool,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partials,
                         int* __restrict__ arrivals, int ck, int KV, int G,
                         int P, int ps, int n_pages, int tstride, float scale,
                         float softcap) {
  constexpr int kTile = wg_tile_bytes<HD>();
  constexpr int kChunks = HD / 8;            // 16-byte chunks of a row
  extern __shared__ uint4 smem_raw[];
  __shared__ int lmax_s, lmin_s;
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + kTile;            // 2 tiles
  const uint32_t Vs = Ks + 2 * kTile;        // 2 tiles

  const int split = blockIdx.x, splits = gridDim.x;
  const int rb = blockIdx.y, n_rb = gridDim.y;
  const int bh = blockIdx.z, b = bh / KV, h = bh % KV;
  const int R0 = rb * kWgRows, nr = min(kWgRows, ck * G - R0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const __nv_bfloat16* kp = kpool + (size_t)h * P * ps * HD;
  const __nv_bfloat16* vp = vpool + (size_t)h * P * ps * HD;
  const int* trow = tables + (size_t)b * tstride;

  // the lengths of this thread's two rows (0 for the padding rows past
  // ck*G), and the block's largest and smallest
  if (threadIdx.x == 0) {
    lmax_s = 0;
    lmin_s = n_pages * ps;
  }
  __syncthreads();
  int len[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    len[r] = row < nr ? max(0, min(lengths[(size_t)b * ck + (R0 + row) / G],
                                   n_pages * ps))
                      : 0;
    if (t == 0) {
      atomicMax(&lmax_s, len[r]);
      atomicMin(&lmin_s, len[r]);
    }
  }
  __syncthreads();
  const int lmax = lmax_s, lmin = lmin_s;
  // this split's tiles: split, split + splits, ... below lmax
  const int n_tiles = (lmax + kWgPos - 1) / kWgPos;
  const int mine = n_tiles > split ? (n_tiles - 1 - split) / splits + 1 : 0;

  if (mine > 0) {
    for (int i = threadIdx.x; i < kWgRows * kChunks; i += kWgThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r < nr;
      cp_async16(Qs + wg_tile_off(r, c),
                 q + (ok ? row_offset(b, h, R0 + r, ck, KV, G, HD) : 0) +
                     c * 8,
                 ok);
    }
    issue_page_tiles<HD>(Ks, Vs, kp, vp, trow, split * kWgPos, lmax, ps);
    cp_async_commit();
  }

  // accumulator element 4n + e: row warp*16 + g + (e / 2) * 8, column
  // 8n + 2t + e % 2 (the mma.sync layout, per 8-column block n)
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float c = softcap > 0.f ? kLog2e : scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

  for (int i = 0; i < mine; ++i) {
    const int kt = split + i * splits, buf = i & 1;
    if (i + 1 < mine) {                // prefetch the next tile
      const int t1 = (kt + splits) * kWgPos;
      issue_page_tiles<HD>(Ks + (buf ^ 1) * kTile, Vs + (buf ^ 1) * kTile,
                           kp, vp, trow, t1, lmax, ps);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // cp.async wrote the tiles through the generic proxy; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t Kt = Ks + buf * kTile, Vt = Vs + buf * kTile;
    const int t0 = kt * kWgPos;

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

    // softcap, mask t >= the row's length (only on tiles that reach past
    // the block's smallest length); online softmax per row (4 lanes share
    // a row)
    const bool masked = t0 + kWgPos > lmin;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e];
      if (softcap > 0.f) x = tanhf(x * cap_in) * softcap;
      if (masked && t0 + (e >> 2) * 8 + 2 * t + (e & 1) >= len[(e >> 1) & 1])
        x = -INFINITY;
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float mc[2];                       // the new max, times c
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no live position yet keeps alpha = p = 0
      mc[r] = m_new == -INFINITY ? 0.f : m_new * c;
      const float alpha = ex2(fmaf(m[r], c, -mc[r]));
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
      const float p = ex2(fmaf(s[e], c, -mc[(e >> 1) & 1]));
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
  constexpr size_t kSplitFloats = (size_t)kWgRows * HD + 2 * kWgRows;
  float* pb = partials + ((size_t)bh * n_rb + rb) * splits * kSplitFloats;
  float* my = pb + (size_t)split * kSplitFloats;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      my[row * HD + 8 * n + 2 * t] = o[4 * n + 2 * r];
      my[row * HD + 8 * n + 2 * t + 1] = o[4 * n + 2 * r + 1];
    }
    if (t == 0) {
      my[kWgRows * HD + row] = m[r] == -INFINITY ? kNegInf : m[r] * c;
      my[kWgRows * HD + kWgRows + row] = l[r];
    }
  }
  __threadfence();
  // m is in log2 units already
  wg_arrive_and_combine<HD>(pb, arrivals + (size_t)bh * n_rb + rb, splits,
                            nr, 1.f, reinterpret_cast<float*>(smem_raw), out,
                            b, h, R0, ck, KV, G);
}

// ============================================================ launch

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const int* tables, const int* lengths, void* out,
                        float* partials, int* arrivals, int B, int ck, int KV,
                        int G, int P, int ps, int hd, int n_pages, int tstride,
                        int RB, int splits, float softcap,
                        cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<T>(RB, hd);
  constexpr int TR = tile_rows<T>(0), TR_WIDE = tile_rows<T>(256);
  auto kernel = hd > 128 ? paged_decode_simt_kernel<T, TR_WIDE>
                         : paged_decode_simt_kernel<T, TR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (ck * G + RB - 1) / RB, B * KV);
  kernel<<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out),
      partials, arrivals, ck, KV, G, P, ps, hd, n_pages, tstride, RB,
      1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* tables, const int* lengths, void* out,
                         float* partials, int* arrivals, int B, int ck,
                         int KV, int G, int P, int ps, int n_pages,
                         int tstride, int splits, float softcap,
                         cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = wg_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_chunk_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (ck * G + kWgRows - 1) / kWgRows, B * KV);
  paged_chunk_wgmma_kernel<HD><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tables, lengths, static_cast<bf16*>(out),
      partials, arrivals, ck, KV, G, P, ps, n_pages, tstride,
      1.0f / sqrtf((float)HD), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q, out (B, ck, KV, G, hd); k, v (KV, P, ps, hd); tables (B, >= n_pages)
// int32 with row stride `tstride`; lengths (B, ck) int32. `rows` is the
// query rows per CTA (64 with `tensor_cores`, which takes bf16 at hd 64,
// 128 and 256; else rows * hd <= 4096) and `splits` the CTAs per (b,
// kv-head, row block). `partials` holds
// B*KV*ceil(ck*G/rows)*splits*(rows*hd + 2*rows) floats; `arrivals` holds
// B*KV*ceil(ck*G/rows) ints, zero before the launch and left at zero after
// it.
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* tables,
                                   const void* lengths, void* out,
                                   void* partials, void* arrivals, int B,
                                   int ck, int KV, int G, int P, int ps,
                                   int hd, int n_pages, int tstride, int rows,
                                   int splits, int tensor_cores,
                                   float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  const int n_rb = rows > 0 ? (ck * G + rows - 1) / rows : 0;
  if (hd % 8 != 0 || ps <= 0 || n_pages < 0 || B <= 0 || ck <= 0 ||
      G <= 0 || rows <= 0 || splits < 1 || splits > 64 || B * KV > 65535 ||
      n_rb > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tp = static_cast<const int*>(tables);
  auto lp = static_cast<const int*>(lengths);
  auto pp = static_cast<float*>(partials);
  auto ap = static_cast<int*>(arrivals);
  if (tensor_cores) {
    if (dtype != kBFloat16 || rows != kWgRows)
      return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 64:
        return (int)launch_wgmma<64>(q, k, v, tp, lp, out, pp, ap, B, ck, KV,
                                     G, P, ps, n_pages, tstride, splits,
                                     softcap, s);
      case 128:
        return (int)launch_wgmma<128>(q, k, v, tp, lp, out, pp, ap, B, ck,
                                      KV, G, P, ps, n_pages, tstride, splits,
                                      softcap, s);
      case 256:
        return (int)launch_wgmma<256>(q, k, v, tp, lp, out, pp, ap, B, ck,
                                      KV, G, P, ps, n_pages, tstride, splits,
                                      softcap, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (rows * hd > kSimtThreads * kMaxAcc) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return (int)launch_simt<float>(q, k, v, tp, lp, out, pp, ap, B, ck, KV,
                                   G, P, ps, hd, n_pages, tstride, rows,
                                   splits, softcap, s);
  if (dtype == kBFloat16)
    return (int)launch_simt<__nv_bfloat16>(q, k, v, tp, lp, out, pp, ap, B,
                                           ck, KV, G, P, ps, hd, n_pages,
                                           tstride, rows, splits, softcap, s);
  return (int)cudaErrorInvalidValue;
}

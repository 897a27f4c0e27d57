// GQA decode attention over a dense KV cache, for Hopper (sm_90a), in two
// forms that share one kernel: one query token per row (the decode step) and
// ck query tokens per row (the dense fused tick's prefill chunk).
//
// Replaces the TPU kernel `flash_decode_bkhd` (`_decode_kernel`) of
// src/repro/kernels/flash_decode.py and, for the dense prefill continuation,
// the reference's loop of one such call per chunk token
// (src/repro/models/attention.py:758-765). q (B,ck,KV,G,hd) attends to k/v
// (B,KV,C,hd) with an additive fp32 validity bias (B,ck,C): query row
// (j, g) of batch row b and KV head h takes the bias row (b, j). The decode
// step is ck = 1, where q is (B,KV,G,hd) and the bias (B,C) in memory.
// Online softmax with fp32 (m, l, acc); scores are scaled by 1/sqrt(hd),
// then soft-capped (tanh, when softcap > 0), then biased; l is floored at
// 1e-30.
//
// What bounds it on this card: bytes. Each call reads the whole K and V of
// its rows once (4.7 MB at the serve path's B=8, KV=4, C=576, hd=64 in
// bf16) for ~2 flops per byte in the decode step; the bound is K+V over
// 3.35 TB/s (~1.4 us). In practice a launch's fixed latency of a few
// microseconds is the floor. The chunk form (ck = 16) does 16x the flops
// on the same bytes, ~32 flops per byte: still bytes on the tensor cores'
// roofline, but the CUDA cores' fp32 FMAs here make it operation-bound in
// practice; one launch replaces ck launches that each read all of K and V.
//
// What the design does about it: the cache axis is split over kSplits = 8
// CTAs per (b, kv-head, block of query rows), one launch: 256 CTAs for the
// decode step at the serve shape, 320 for hymba-1.5b's 5 KV heads, where
// one CTA per (b, kv-head) left most of the 132 SMs idle. A block of query
// rows is the G rows of a decode step, or in the chunk form whole groups of
// G rows (j-major: rows j*G .. j*G+G-1 share the bias row of token j), as
// many as the accumulators hold (rows*hd <= 4096: 64 rows, 8 chunk tokens,
// at hd 64; 32 at hd 128; 16 at hd 256, gemma-2b's two tokens of its group
// of 8), so K and V are read once per block for all its
// query rows. Each CTA takes ceil(C/8) consecutive positions, streams them
// through a double-buffered shared-memory ring with `cp.async` (the next
// tile, its K, V and the block's bias rows, is in flight while this one is
// scored and summed; at the serve shape a split's 72 positions are one
// 128-position tile), and keeps the block's query rows resident in fp32.
// Scores are spread over all threads as (row, position) pairs; P.V as
// (row, hd column) outputs, with several FMA chains per thread. Each CTA
// writes its partial (m, l, acc) for its rows to a scratch workspace and
// arrives on its block's counter; the last to arrive combines the eight
// partials (weights exp(m_r - M) / L once per row, then one pass over the
// rows*hd outputs) and sets the counter back to zero for the next launch.
// A split that saw no valid position (C below the split count, or every
// position under the -1e9 bias while another split holds a real score) has
// m = -1e30 or about -1e9, l = 0 or its own sum and an accumulator of its
// own, so its weight is exp(-1e9 - M) = 0 and it adds nothing: no NaN, no
// garbage. Rows are independent throughout: a padded chunk query or an
// inert row (its outputs discarded by the caller) reads stale but finite
// cache entries and cannot reach another row's sums. The ragged tail and
// the validity bias are masked inside the kernel; nothing pads or copies
// the cache. The decode step runs exactly the arithmetic of the one-token
// kernel this generalises (same order of every sum), and, as its own
// instantiation (kChunk false), also its addressing: contiguous q/out rows
// and one bias row, no per-element division by G.
//
// Not a thread-block cluster: the same split with the partials combined
// through distributed shared memory after `cluster.sync()` took about 1.5x
// as long on the H100 at the serve shape, and a launch with the cluster
// attribute alone, no cluster barrier, cost the same, so the cluster
// scheduling itself is the cost at these 79 KB blocks. (The tensor-core
// step kernel, at 26-81 KB a CTA, gains from its cluster combine:
// flash_decode_step.cu.)
//
// fp32 and bf16 run the same kernel; the products are fp32 FMAs on the
// CUDA cores in both, so fp32 keeps full fp32 products.
//
// Routes elsewhere (the wrapper's launch_plan): the chunk form in bf16 at
// hd 64, 128 and 256 runs flash_decode_chunk.cu, and the decode step in
// bf16 at hd 64, 128 and 256 with G <= 16 flash_decode_step.cu, both on
// the tensor cores; this kernel keeps fp32 and groups above 16 rows. This
// kernel at gemma's decode step (B 8, G 8 on one KV head, C
// 576, hd 256) left the card two-thirds idle: 8 splits gave 64 CTAs on 132
// SMs, its 64-position tiles took each split's 72 positions in two rounds,
// and its fp32 FMAs ran the products: 0.0303 ms device on an NVIDIA H100
// 80GB HBM3 at 700 W, 2.2x SDPA.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 16;   // accumulators per thread: G*hd <= 4096
constexpr int kSplits = 8;    // CTAs per (b, kv-head, row block), one cache
                              // slice each

// Elements per 16-byte vector: K rows are padded by one vector, so lanes
// that read consecutive rows with 16-byte loads hit distinct banks.
template <typename T>
__host__ __device__ constexpr int kvec() { return 16 / sizeof(T); }

// Cache positions per shared-memory tile: 128 in bf16 (one tile holds a
// split's 72 positions at the serve shape), 64 in fp32 (so G*hd = 4096 at
// hd 128 still fits the ring in shared memory); half that above hd 128, so
// the K/V ring does not grow with hd (gemma-2b's hd 256: 64 positions in
// bf16, 133 KB of ring, where 128 would need 266 KB, past one block's
// 227 KB).
template <typename T>
constexpr int tile_rows(int hd) {
  return (sizeof(T) == 2 ? 128 : 64) / (hd > 128 ? 2 : 1);
}

// Shared layout: K ring (2, TR, hd + pad) T | V ring (2, TR, hd) T |
// bias ring (2, NJ, TR) | q (RB, hd) | p (RB, TR) | m, l, alpha (RB) fp32,
// for a block of RB query rows over NJ = RB / G chunk tokens.
template <typename T>
size_t smem_bytes(int RB, int NJ, int hd) {
  const int TR = tile_rows<T>(hd);
  return sizeof(T) * 2 * TR * ((size_t)(hd + kvec<T>()) + hd) +
         sizeof(float) * ((size_t)2 * NJ * TR + (size_t)RB * hd +
                          (size_t)RB * TR + 3 * RB);
}

// Start the copy of `rows` cache positions from j0 of this split: K and V
// rows (hd elements; K rows land with stride ldk) and the biases of the
// block's nj chunk tokens (bias rows ldb apart in memory, TR apart in bs).
template <typename T, bool kChunk, int TR>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, float* bs, int ldk,
                                           const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const float* __restrict__ bp,
                                           int j0, int rows, int hd, int nj,
                                           int ldb) {
  constexpr int V = kvec<T>();
  const int per_row = hd / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * V;
    const size_t src = (size_t)(j0 + r) * hd + c;
    cp_async16(ks + r * ldk + c, kp + src);
    cp_async16(vs + r * hd + c, vp + src);
  }
  if (!kChunk) {                     // the decode step: one bias row
    for (int r = threadIdx.x; r < rows; r += kThreads)
      cp_async4(bs + r, bp + j0 + r);
  } else {
    for (int i = threadIdx.x; i < nj * rows; i += kThreads) {
      const int t = i / rows, r = i % rows;
      cp_async4(bs + t * TR + r, bp + (size_t)t * ldb + j0 + r);
    }
  }
}

// Partials of one (b, kv-head, row block) of RB rows: acc (kSplits, RB*hd),
// then m and l (kSplits, RB) each, fp32.
__device__ __forceinline__ size_t partial_floats(int RB, int hd) {
  return (size_t)kSplits * ((size_t)RB * hd + 2 * RB);
}

// Element offset of query row `row` (= j * G + g) of (b, h) in the
// (B, ck, KV, G, hd) layout of q and out (the chunk form; the decode step's
// G rows of (b, h) are contiguous).
__device__ __forceinline__ size_t row_offset(int b, int h, int row, int ck,
                                             int KV, int G, int hd) {
  const int j = row / G, g = row % G;
  return ((((size_t)b * ck + j) * KV + h) * G + g) * hd;
}

template <typename T, bool kChunk, int kTile>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ partials,
                    int* __restrict__ arrivals, int KV, int G, int C, int hd,
                    int ck, int RB, float scale, float softcap) {
  constexpr int V = kvec<T>();
  extern __shared__ uint4 smem_raw[];
  __shared__ bool last;
  const int ldk = hd + V;
  // The decode step (kChunk false) is one block of G rows and one bias
  // row. Its sizes are the one-token kernel's, spelled as G: with RB a
  // second live value the bf16 instantiation took ~4% longer on the H100.
  if (!kChunk) RB = G;
  const int NJ = kChunk ? RB / G : 1;         // chunk tokens of a full block
  T* ks = reinterpret_cast<T*>(smem_raw);    // (2, kTile, ldk)
  T* vs = ks + 2 * kTile * ldk;               // (2, kTile, hd)
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile * hd);  // (2, NJ, kTile)
  float* qs = bs + 2 * NJ * kTile;            // (RB, hd)
  float* ps = qs + RB * hd;                   // (RB, kTile) scores, probs
  float* m_s = ps + RB * kTile;               // (RB,) running max
  float* l_s = m_s + RB;                      // (RB,) running sum
  float* a_s = l_s + RB;                      // (RB,) this tile's rescale

  const int split = blockIdx.x;
  const int bh = blockIdx.y;                  // b * KV + kv-head
  const int b = bh / KV, h = bh % KV;
  const int row0 = kChunk ? blockIdx.z * RB : 0;  // first row (j*G + g)
  const int nrows = kChunk ? min(RB, ck * G - row0) : G;  // whole groups
  const int nj = kChunk ? nrows / G : 1;
  const int blk = kChunk ? bh * gridDim.z + blockIdx.z : bh;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = kThreads / 32;
  const int RH = nrows * hd;
  const int chunk = (C + kSplits - 1) / kSplits;
  const int c0 = min(C, split * chunk), n = min(C, c0 + chunk) - c0;
  const int n_tiles = (n + kTile - 1) / kTile;
  const T* kp = k + ((size_t)bh * C + c0) * hd;
  const T* vp = v + ((size_t)bh * C + c0) * hd;
  const float* bp =
      bias + (kChunk ? ((size_t)b * ck + row0 / G) * C : (size_t)b * C) + c0;

  if (n_tiles > 0) {
    issue_tile<T, kChunk, kTile>(ks, vs, bs, ldk, kp, vp, bp, 0,
                                 min(kTile, n), hd, nj, C);
    cp_async_commit();
  }
  for (int i = tid; i < RH; i += kThreads)
    qs[i] = to_float(
        kChunk ? q[row_offset(b, h, row0 + i / hd, ck, KV, G, hd) + i % hd]
               : q[(size_t)bh * RH + i]);
  for (int r = tid; r < nrows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const int rows = min(kTile, n - j0);
    const T* kt = ks + (t & 1) * kTile * ldk;
    const T* vt = vs + (t & 1) * kTile * hd;
    const float* bt = bs + (t & 1) * NJ * kTile;
    if (t + 1 < n_tiles) {             // prefetch the next tile
      const int nb = (t + 1) & 1;
      issue_tile<T, kChunk, kTile>(
          ks + nb * kTile * ldk, vs + nb * kTile * hd, bs + nb * NJ * kTile,
          ldk, kp, vp, bp, j0 + kTile, min(kTile, n - j0 - kTile), hd, nj,
          C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scores for every (r, j < rows) of the tile: x 1/sqrt(hd), softcap,
    // + the bias of row r's chunk token; a warp's lanes take consecutive
    // positions j
    for (int e = tid; e < nrows * rows; e += kThreads) {
      const int r = e / rows, j = e % rows;
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
      ps[r * kTile + j] = s + bt[kChunk ? (r / G) * kTile + j : j];
    }
    __syncthreads();
    // online softmax: one warp per query row of the block
    for (int r = warp; r < nrows; r += nwarps) {
      float* pr = ps + r * kTile;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
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
    // acc(r, d) = acc * alpha(r) + sum_j p(r, j) v(j, d)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < RH) {
        const int r = e / hd, d = e % hd;
        const float* pr = ps + r * kTile;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        int j = 0;
        for (; j + 3 < rows; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pv[u] = fmaf(pr[j + u], to_float(vt[(j + u) * hd + d]), pv[u]);
        }
        for (; j < rows; ++j)
          pv[0] = fmaf(pr[j], to_float(vt[j * hd + d]), pv[0]);
        acc[i] = acc[i] * a_s[r] + ((pv[0] + pv[1]) + (pv[2] + pv[3]));
      }
    }
    __syncthreads();                   // this buffer is refilled next round
  }

  // publish this split's partial; the last split to arrive combines
  float* pb = partials + (size_t)blk * partial_floats(RB, hd);
  float* pm = pb + (size_t)kSplits * RB * hd;   // (kSplits, RB) m, then l
  float* pl = pm + kSplits * RB;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < RH) pb[(size_t)split * RH + e] = acc[i];
  }
  for (int r = tid; r < nrows; r += kThreads) {
    pm[split * RB + r] = m_s[r];
    pl[split * RB + r] = l_s[r];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();                   // this CTA's partials, then arrive
    last = atomicAdd(arrivals + blk, 1) == kSplits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // weights w(s, r) = exp(m_s - M) / sum_s l_s exp(m_s - M), into ps
  for (int r = tid; r < nrows; r += kThreads) {
    float mr[kSplits], M = kNegInf, L = 0.f;
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) {
      mr[sp] = __ldcg(pm + sp * RB + r);
      M = fmaxf(M, mr[sp]);
    }
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) {
      mr[sp] = expf(mr[sp] - M);
      L = fmaf(__ldcg(pl + sp * RB + r), mr[sp], L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) ps[sp * RB + r] = mr[sp] * inv;
  }
  __syncthreads();
  for (int e = tid; e < RH; e += kThreads) {
    const int r = e / hd;
    float O = 0.f;
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp)
      O = fmaf(__ldcg(pb + (size_t)sp * RH + e), ps[sp * RB + r], O);
    store(kChunk ? out + row_offset(b, h, row0 + r, ck, KV, G, hd) + e % hd
                 : out + (size_t)bh * RH + e,
          O);
  }
  if (tid == 0) arrivals[blk] = 0;     // ready for the next launch
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* partials,
                   int* arrivals, int B, int KV, int G, int C, int hd, int ck,
                   int RB, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(RB, RB / G, hd);
  // ck = 1 is the decode step: one block of G rows, plain addressing
  constexpr int TR = tile_rows<T>(0), TR_WIDE = tile_rows<T>(256);
  auto kernel = hd > 128 ? (ck == 1 ? flash_decode_kernel<T, false, TR_WIDE>
                                    : flash_decode_kernel<T, true, TR_WIDE>)
                         : (ck == 1 ? flash_decode_kernel<T, false, TR>
                                    : flash_decode_kernel<T, true, TR>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = (ck * G + RB - 1) / RB;
  kernel<<<dim3(kSplits, B * KV, n_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), partials,
      arrivals, KV, G, C, hd, ck, RB, 1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, ck, KV, G, hd), bias (B, ck, C); `rows` query rows per
// CTA, a multiple of G with rows * hd <= 4096 (G for the decode step, ck =
// 1). With n = ceil(ck * G / rows) row blocks, `partials` holds
// B*KV*n*kSplits*(rows*hd + 2*rows) floats and `arrivals` B*KV*n ints, zero
// before the launch and left at zero after it.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   void* out, void* partials, void* arrivals,
                                   int B, int KV, int G, int C, int hd,
                                   int ck, int rows, float softcap, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (G <= 0 || rows < G || rows % G != 0 ||
      rows * hd > kThreads * kMaxAcc || hd % 8 != 0 || C <= 0 || ck <= 0 ||
      B * KV > 65535 || (ck * G + rows - 1) / rows > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const float*>(bias);
  auto pp = static_cast<float*>(partials);
  auto ap = static_cast<int*>(arrivals);
  if (dtype == kFloat32)
    return (int)launch<float>(q, k, v, bp, out, pp, ap, B, KV, G, C, hd, ck,
                              rows, softcap, s);
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16>(q, k, v, bp, out, pp, ap, B, KV, G, C,
                                      hd, ck, rows, softcap, s);
  return (int)cudaErrorInvalidValue;
}

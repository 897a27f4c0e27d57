// One-token GQA decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_decode_bkhd` (`_decode_kernel`) of
// src/repro/kernels/flash_decode.py: q (B,KV,G,hd) attends to k/v
// (B,KV,C,hd) with an additive fp32 validity bias (B,C); online softmax
// with fp32 (m, l, acc); scores are scaled by 1/sqrt(hd), then soft-capped
// (tanh, when softcap > 0), then biased; l is floored at 1e-30.
//
// What bounds it on this card: bytes. Each call reads the whole K and V of
// its rows once (4.7 MB at the serve path's B=8, KV=4, C=576, hd=64 in
// bf16) for ~2 flops per byte, far below the ~295 flop/byte at which the
// tensor cores become the limit; the bound is K+V over 3.35 TB/s (~1.4 us).
// In practice a launch's fixed latency of a few microseconds is the floor.
//
// What the design does about it: the cache axis is split over kSplits = 8
// CTAs per (b, kv-head), one launch: 256 CTAs at the serve shape, 320 for
// hymba-1.5b's 5 KV heads, where one CTA per (b, kv-head) left most of the
// 132 SMs idle. Each CTA takes ceil(C/8) consecutive positions, streams
// them through a double-buffered shared-memory ring with `cp.async` (the
// next tile is in flight while this one is scored and summed; at the serve
// shape a split's 72 positions are one 128-position tile), and keeps the G
// query rows of the group resident, so K and V are read from device memory
// once for all G heads that share them. Scores are spread over all threads
// as (row, position) pairs; P.V as (row, hd column) outputs, with several
// FMA chains per thread. Each CTA writes its partial (m, l, acc) for the G
// rows to a scratch workspace and arrives on its (b, kv-head)'s counter;
// the last to arrive combines the eight partials (weights exp(m_r - M) / L
// once per row, then one pass over the G*hd outputs) and sets the counter
// back to zero for the next launch. A split that saw no valid position (C
// below the split count, or every position under the -1e9 bias while
// another split holds a real score) has m = -1e30, l = 0 and an
// accumulator of zeros, so its weight is 0 and it adds nothing: no NaN, no
// garbage. The ragged tail and the validity bias are masked inside the
// kernel; nothing pads or copies the cache.
//
// Not a thread-block cluster: the same split with the partials combined
// through distributed shared memory after `cluster.sync()` took about 1.5x
// as long on the H100 at the serve shape, and a launch with the cluster
// attribute alone, no cluster barrier, cost the same, so the cluster
// scheduling itself is the cost at these 79 KB blocks.
//
// fp32 and bf16 run the same kernel; the products are fp32 FMAs on the
// CUDA cores in both (decode does ~2 flops per byte), so fp32 keeps full
// fp32 products.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 16;   // accumulators per thread: G*hd <= 4096
constexpr int kSplits = 8;    // CTAs per (b, kv-head), one cache slice each

// Elements per 16-byte vector: K rows are padded by one vector, so lanes
// that read consecutive rows with 16-byte loads hit distinct banks.
template <typename T>
__host__ __device__ constexpr int kvec() { return 16 / sizeof(T); }

// Cache positions per shared-memory tile: 128 in bf16 (one tile holds a
// split's 72 positions at the serve shape), 64 in fp32 (so G*hd = 4096 at
// hd 128 still fits the ring in shared memory).
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 128 : 64;
}

// Shared layout: K ring (2, TR, hd + pad) T | V ring (2, TR, hd) T |
// bias ring (2, TR) | q (G, hd) | p (G, TR) | m, l, alpha (G) fp32.
template <typename T>
size_t smem_bytes(int G, int hd) {
  constexpr int TR = tile_rows<T>();
  return sizeof(T) * 2 * TR * ((size_t)(hd + kvec<T>()) + hd) +
         sizeof(float) * ((size_t)2 * TR + (size_t)G * hd + (size_t)G * TR +
                          3 * G);
}

// Start the copy of `rows` cache positions from j0 of this split: K and V
// rows (hd elements; K rows land with stride ldk) and their biases.
template <typename T>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, float* bs, int ldk,
                                           const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const float* __restrict__ bp,
                                           int j0, int rows, int hd) {
  constexpr int V = kvec<T>();
  const int per_row = hd / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * V;
    const size_t src = (size_t)(j0 + r) * hd + c;
    cp_async16(ks + r * ldk + c, kp + src);
    cp_async16(vs + r * hd + c, vp + src);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    cp_async4(bs + r, bp + j0 + r);
}

// Partials of one (b, kv-head): acc (kSplits, G*hd), then m and l
// (kSplits, G) each, fp32.
__device__ __forceinline__ size_t partial_floats(int G, int hd) {
  return (size_t)kSplits * ((size_t)G * hd + 2 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ partials,
                    int* __restrict__ arrivals, int KV, int G, int C, int hd,
                    float scale, float softcap) {
  constexpr int V = kvec<T>();
  constexpr int kTile = tile_rows<T>();
  extern __shared__ uint4 smem_raw[];
  __shared__ bool last;
  const int ldk = hd + V;
  T* ks = reinterpret_cast<T*>(smem_raw);    // (2, kTile, ldk)
  T* vs = ks + 2 * kTile * ldk;               // (2, kTile, hd)
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile * hd);  // (2, kTile)
  float* qs = bs + 2 * kTile;                 // (G, hd)
  float* ps = qs + G * hd;                    // (G, kTile) scores, probs
  float* m_s = ps + G * kTile;                // (G,) running max
  float* l_s = m_s + G;                       // (G,) running sum
  float* a_s = l_s + G;                       // (G,) this tile's rescale

  const int split = blockIdx.x;
  const int bh = blockIdx.y;                  // b * KV + kv-head
  const int b = bh / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = kThreads / 32;
  const int GH = G * hd;
  const int chunk = (C + kSplits - 1) / kSplits;
  const int c0 = min(C, split * chunk), n = min(C, c0 + chunk) - c0;
  const int n_tiles = (n + kTile - 1) / kTile;
  const T* kp = k + ((size_t)bh * C + c0) * hd;
  const T* vp = v + ((size_t)bh * C + c0) * hd;
  const float* bp = bias + (size_t)b * C + c0;

  if (n_tiles > 0) {
    issue_tile(ks, vs, bs, ldk, kp, vp, bp, 0, min(kTile, n), hd);
    cp_async_commit();
  }
  const T* qp = q + (size_t)bh * GH;
  for (int i = tid; i < GH; i += kThreads) qs[i] = to_float(qp[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const int rows = min(kTile, n - j0);
    const T* kt = ks + (t & 1) * kTile * ldk;
    const T* vt = vs + (t & 1) * kTile * hd;
    const float* bt = bs + (t & 1) * kTile;
    if (t + 1 < n_tiles) {             // prefetch the next tile
      const int nb = (t + 1) & 1;
      issue_tile(ks + nb * kTile * ldk, vs + nb * kTile * hd, bs + nb * kTile,
                 ldk, kp, vp, bp, j0 + kTile, min(kTile, n - j0 - kTile), hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scores for every (g, j < rows) of the tile: x 1/sqrt(hd), softcap,
    // + bias; a warp's lanes take consecutive positions j
    for (int e = tid; e < G * rows; e += kThreads) {
      const int g = e / rows, j = e % rows;
      const float* qr = qs + g * hd;
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
      ps[g * kTile + j] = s + bt[j];
    }
    __syncthreads();
    // online softmax: one warp per query row of the group
    for (int g = warp; g < G; g += nwarps) {
      float* pr = ps + g * kTile;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
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
        const float* pr = ps + g * kTile;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        int j = 0;
        for (; j + 3 < rows; j += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pv[u] = fmaf(pr[j + u], to_float(vt[(j + u) * hd + d]), pv[u]);
        }
        for (; j < rows; ++j)
          pv[0] = fmaf(pr[j], to_float(vt[j * hd + d]), pv[0]);
        acc[i] = acc[i] * a_s[g] + ((pv[0] + pv[1]) + (pv[2] + pv[3]));
      }
    }
    __syncthreads();                   // this buffer is refilled next round
  }

  // publish this split's partial; the last split to arrive combines
  float* pb = partials + (size_t)bh * partial_floats(G, hd);
  float* pm = pb + (size_t)kSplits * GH;     // (kSplits, G) m, then l
  float* pl = pm + kSplits * G;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < GH) pb[(size_t)split * GH + e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    pm[split * G + g] = m_s[g];
    pl[split * G + g] = l_s[g];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();                   // this CTA's partials, then arrive
    last = atomicAdd(arrivals + bh, 1) == kSplits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // weights w(r, g) = exp(m_r - M) / sum_r l_r exp(m_r - M), into ps
  for (int g = tid; g < G; g += kThreads) {
    float mr[kSplits], M = kNegInf, L = 0.f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      mr[r] = __ldcg(pm + r * G + g);
      M = fmaxf(M, mr[r]);
    }
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      mr[r] = expf(mr[r] - M);
      L = fmaf(__ldcg(pl + r * G + g), mr[r], L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int r = 0; r < kSplits; ++r) ps[r * G + g] = mr[r] * inv;
  }
  __syncthreads();
  T* op = out + (size_t)bh * GH;
  for (int e = tid; e < GH; e += kThreads) {
    const int g = e / hd;
    float O = 0.f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r)
      O = fmaf(__ldcg(pb + (size_t)r * GH + e), ps[r * G + g], O);
    store(op + e, O);
  }
  if (tid == 0) arrivals[bh] = 0;      // ready for the next launch
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* partials,
                   int* arrivals, int B, int KV, int G, int C, int hd,
                   float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T><<<dim3(kSplits, B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), partials,
      arrivals, KV, G, C, hd, 1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// `partials` holds B*KV*kSplits*(G*hd + 2G) floats; `arrivals` holds B*KV
// ints, zero before the launch and left at zero after it.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   void* out, void* partials, void* arrivals,
                                   int B, int KV, int G, int C, int hd,
                                   float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  if (G * hd > kThreads * kMaxAcc || hd % 8 != 0 || C <= 0 ||
      B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const float*>(bias);
  auto pp = static_cast<float*>(partials);
  auto ap = static_cast<int*>(arrivals);
  if (dtype == kFloat32)
    return (int)launch<float>(q, k, v, bp, out, pp, ap, B, KV, G, C, hd,
                              softcap, s);
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16>(q, k, v, bp, out, pp, ap, B, KV, G, C,
                                      hd, softcap, s);
  return (int)cudaErrorInvalidValue;
}

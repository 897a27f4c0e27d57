// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_bkhd` (`_prefill_kernel`) of
// src/repro/kernels/flash_prefill.py: causal attention with an optional
// sliding window (window > 0: key j is visible to query i iff
// i - window < j <= i) and optional tanh softcap; scores are scaled by
// 1/sqrt(hd) then soft-capped; masked scores are -1e30; fp32 online
// softmax and accumulation; l floored at 1e-30.
//
// It takes the model layout directly: q (B,S,H,hd), k/v (B,S,KV,hd) ->
// out (B,S,H,hd). The TPU wrapper's (B,KV,G,S,hd) relayout and the
// padding of S to a block multiple are gone: the kernel computes its
// offsets from the strides and masks the ragged S edge itself.
//
// What bounds it on this card: bytes, at the serve path's shapes
// (B=8, S=512, H=32, KV=4, hd=64, bf16): reading q, k, v and writing out
// is ~37.7 MB (~11.3 us at 3.35 TB/s) against ~8.6 GFLOP of causal
// products (~8.7 us on the bf16 tensor cores). Both are near, so the
// products have to run on the tensor cores for the bytes to set the pace.
//
// bf16 at hd 64 (the serve path: tinyllama-1.1b's 32 query heads on 4 KV
// heads, granite-moe's G 3, whisper-tiny's decoder G 1, hymba-1.5b's G 5
// with a window of 256) runs `flash_prefill_wide_kernel<64, 1>` below: one
// warpgroup and one head a CTA, tiles copied by TMA, four CTAs an SM. At hd
// 64 a key tile's products are short (QK^T four m64n64k16 k-steps, PV eight
// with P's lo term), so a CTA's time goes to its chain of waits (copies,
// products, softmax and rescale of a tile, in turn), and the SM hides one
// CTA's waits behind the other three's work. For four CTAs to fit, a
// thread keeps within 128 registers: the hd-64 step issues PV_{i-1} and
// QK^T_i back to back and waits for both before the softmax, so the
// softmax never holds P beside S (127 registers, no spill), where the
// hd-128 order (softmax under PV) spills 84 bytes at four CTAs; the next
// tiles' copies start once the step's products are issued. P enters PV
// as two bf16 terms, its rounding and the residual's (hi + lo, 16
// mantissa bits): a single bf16 P moves an output by up to 2^-9 of its
// size, which at |out| in [2, 4) flips its bf16 rounding by one ulp
// (0.0156) against the plain version's fp32 P, past the 1e-2 absolute
// tolerance; two terms leave the error at fp32's order.
// Measured (device ms, tinyllama / granite / whisper at B 8, S 512;
// NVIDIA H100 80GB HBM3 at 700.00 W; `kernel_variants.py --hd 64 --parent`,
// one call): this kernel 0.0383-0.0391 / 0.0300-0.0301 / 0.0116; with the
// copies started before the products 0.0388-0.0390 / 0.0303-0.0304 /
// 0.0121 (125 registers); with PV_{i-1} waited for before QK^T_i is issued
// 0.0396-0.0398 / 0.0310-0.0311 / 0.0124-0.0125 (125); with the hd-128
// step order 0.0409-0.0410 / 0.0324 / 0.0123-0.0124 (128 registers, 84
// bytes spilled), the same at three CTAs 0.0427-0.0429 / 0.0331 /
// 0.0117-0.0118 (162 registers); this order at three CTAs 0.0427-0.0428 /
// 0.0330-0.0331 / 0.0115 (150), at five 0.0454-0.0455 / 0.0352-0.0354 /
// 0.0141-0.0142 (96, 56 bytes spilled); masked tiles by two bounds a row
// 0.0461-0.0462 / 0.0355-0.0357 / 0.0144. With wrong results, to see where
// the time goes (tinyllama): no softmax 0.0300-0.0307, no PV 0.0318-0.0343,
// no lo term 0.0339-0.0340, no copies after the first K tile 0.0361. The
// kernel it replaced, the one-warpgroup `flash_prefill_wgmma_kernel` with
// `cp.async` copies and a __syncthreads a tile (four CTAs an SM, 128
// registers), ran 0.0519-0.0520 / 0.0402-0.0404 / 0.0154 (tinyllama: no
// softmax 0.0408-0.0409, no lo term 0.0453-0.0455, no PV 0.0428, no copies
// 0.0425-0.0426).
// Tried and left out, a ping-pong kernel (`flash_prefill_pingpong_kernel`
// of commit 5e2cceb: `git archive 5e2cceb | tar -x -C build/pingpong`,
// then `kernel_variants.py --hd 64 --parent build/pingpong`, and that
// checkout's own kernel_variants.py for its variants): one persistent CTA
// an SM of three warpgroups, a producer warpgroup issuing every TMA copy
// into rings whose slots the consumers release through mbarriers, two
// consumer warpgroups on the 64-row halves of a 128-query item over one
// stream of 128-key tiles (QK^T m64n128k16), taking turns on named
// barriers to issue their products and running tile i's softmax under
// PV_{i-1}, registers moved by setmaxnreg (240 for the consumers, 24 for
// the producer; 168 at entry, no spill): 0.0462-0.0464 / 0.0374-0.0386 /
// 0.0156-0.0158. Its eight consumer warps an SM cannot hide a softmax that
// takes as long as the other warpgroup's products (tinyllama: no softmax
// 0.0310-0.0339; its turns saved 2%; without setmaxnreg 0.0588-0.0590;
// one CTA an item 0.0604-0.0608; three-slot rings no change). Key tiles
// wholly above the causal frontier or before the window are never loaded,
// and the mask is evaluated only on tiles that cross the diagonal, the
// window edge or the ragged end of S. The grid runs the
// q-tile index in reverse, so the heaviest causal tiles start first and
// the light ones fill the tail.
//
// bf16 at hd 32 (no config; the reference kernel test's shape): one CTA of
// four warps per (b, head, 64-query tile) on `mma.sync.m16n8k16` fed by
// `ldmatrix`, each warp owning 16 query rows and keeping its Q fragments
// in registers, K and V copied by `cp.async` into two-tile rings, P as hi
// + lo bf16 terms.
//
// bf16 at hd 64, 128 and 256, `flash_prefill_wide_kernel<HD, kHeads>`. At
// gemma-2b's prefill (B 8, S 512, 8 query heads on one KV head of hd 256)
// what bounds it is bytes, barely: q, k, v and out are 37.7 MB (11.3 us at
// 3.35 TB/s) against 8.6 GFLOP of causal QK^T and PV, 8.7 us on the bf16
// tensor cores, or 13 us with PV doubled by P's hi + lo terms. At
// internvl2-26b's (48 query heads on 8 KV heads of hd 128: G 6) q, k, v
// and out are 117 MB (35 us) against 25.8 GFLOP (26 us, 39 us with PV
// doubled). Either way the products must run on `wgmma` near its rate.
// The design:
// - One warpgroup a query head: its 64 query rows and all HD output
//   columns (HD / 2 fp32 accumulators a thread). QK^T is HD / 16 `wgmma`
//   m64n64k16 k-steps from swizzled shared memory (a 64 x HD tile is HD /
//   64 sub-tiles of 8 KB), PV four m64nHDk16 k-steps a term with P from
//   registers and V's leading byte offset stepping over its sub-tiles
//   (wgmma.cuh). At hd 256 a CTA is two warpgroups, the query heads 2p and
//   2p + 1 of one KV head at one 64-query tile over one K/V stream (at odd
//   G the group's last CTA has one head, and its second warpgroup computes
//   on a copy of it and stores nothing, which keeps the products off any
//   divergent path: ptxas serialises `wgmma`s on one); one CTA an SM. At
//   hd 128 a CTA is one warpgroup and one head (82,944 bytes, 212
//   registers), so two CTAs share an SM and run apart, where the two-head
//   CTA (99,328 bytes, one an SM at 226 registers; two an SM cap them at
//   128 and spill 312 bytes) has its warpgroups meet at a barrier every
//   key tile.
// - Softmax overlaps the products (at hd 128 and 256; at hd 64 it runs
//   after PV_{i-1} and QK^T_i, see above). Step i issues QK^T of key tile i
//   and then PV of tile i - 1, waits for QK^T alone (`wgmma.wait_group
//   1`), and runs tile i's mask and exponentials while PV_{i-1} is in
//   flight; only the rescale of the accumulator waits for it. P splits
//   into its hi + lo terms with hi truncated (split_bf16_trunc): one
//   conversion a pair.
// - The tensor memory accelerator copies every tile: one thread starts Q
//   and the first K tile, then at each step K_{i+1} and V_i, each tile as
//   HD / 64 boxes that land in the `wgmma` swizzle, with rows at or past S
//   zero-filled by the hardware; each ring slot has an mbarrier whose
//   phase the threads wait on. K streams one tile ahead and V one step
//   behind it through two-tile rings. Tiles above the causal frontier or
//   before the window are never loaded; the mask is evaluated only on
//   tiles that cross it; scale, then softcap, then mask; l is floored at
//   1e-30; a row with no visible key keeps alpha = p = 0. The heaviest q
//   tiles start first.
// - The output tile is staged in the warpgroup's finished Q tile in the
//   same swizzle and stored as whole rows (2 HD bytes).
// Measured (device ms, NVIDIA H100 80GB HBM3 at 700 W; chip_smoke --ab,
// parent and change in one call): internvl's prefill 0.1054 (the
// `mma.sync` route 0.1876, SDPA 0.0714, bound 0.0351 (bytes); ptxas 208
// registers, no spill), gemma's 0.0324-0.0340 (0.0396-0.0400 before TMA,
// SDPA 0.0334; 242 registers, no spill). What holds hd 128 at 1.5x SDPA:
// P's lo term doubles PV (the products are 1.5x those SDPA runs, and with
// one bf16 P the outputs miss the 1e-2 check), and each warpgroup's step
// runs its softmax, the wait for PV and the rescale in sequence with no
// second consumer to fill the tensor cores. kernel_variants.py, one call
// (this kernel 0.1044 / gemma 0.0326): with wrong results, to see where
// the time goes, no softmax 0.0862, no lo term 0.0929, no PV 0.0949, no
// copies after the first K tile 0.0982; two heads a CTA 0.1155 (206
// registers); Q's A fragments held in registers, so QK^T reads only K
// from shared memory, 0.1034 (238 registers: within 1%, not kept); the
// hi term rounded 0.1069; skipping the rescale of a warp whose rows keep
// their max 0.1084; the accumulator layout's own 4-byte stores 0.1182
// (0.0400 at gemma). Double-buffering P so that tile i's split runs under
// PV_{i-1} gave 0.1066 against 0.1071 and spilled at hd 256: left out.
// Before TMA the threads copied the tiles with `cp.async` (16-byte copies,
// a swizzle an add and a compare): internvl one head a CTA 0.1306, two
// heads 0.1352, gemma 0.0394; kernel_variants.py in that form: two heads
// two CTAs an SM 0.1427, the copies issued after the products 0.1379
// (0.0400 at gemma), Q's A fragments held in registers 0.1287, a generic
// copy loop 0.1470, without the copies (wrong results) 0.1108. The first
// routes: `mma.sync` at hd 128 (a warp per 16 query rows, each reading
// the whole K and V tile), internvl 0.1892; at hd 256 two warpgroups
// splitting the output columns, gemma 0.0924.
//
// fp32 keeps fp32 products (no TF32: the fp32 checks hold the kernel to
// 1e-5 of the plain version, and the fp32 model rungs must give the same
// greedy tokens with the kernels on and off): one CTA per (b, head,
// 64-query tile) walks the same key tiles on the CUDA cores, Q, K, V and
// the probabilities in shared memory as fp32, register-tiled 4x8 micro
// tiles, the same heaviest-first grid.
#include <cuda.h>  // CUtensorMap (its encoder is looked up at run time)

#include "wgmma.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per tile

// Whether any (query, key) pair of the tiles starting at q0 and k0 is
// masked: the tile crosses the diagonal, the window edge or the end of S.
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, int S,
                                                int window) {
  return k0 + kBK - 1 > q0 || k0 + kBK > S ||
         (window > 0 && k0 <= q0 + kBQ - 1 - window);
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int window) {
  return kj <= qi && kj < S && (window <= 0 || kj > qi - window);
}

// ============================================================ bf16: mma.sync
// (hd 32)

// bf16 elements per shared-memory row: hd plus 16 bytes, so the 8 rows an
// `ldmatrix` reads start in 8 different 4-bank groups.
template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }

template <int HD>
constexpr size_t mma_smem_bytes() {  // Q | K ring (2) | V ring (2)
  return 5 * (size_t)kBQ * mma_ld<HD>() * sizeof(__nv_bfloat16);
}

// Start the copy of rows [r0, r0+64) of a (S, stride) bf16 slab into a
// shared tile; rows at or past S are zero-filled.
template <int HD>
__device__ __forceinline__ void issue_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base,
                                           size_t stride, int r0, int S) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * mma_ld<HD>() + c,
               base + (size_t)(ok ? r0 + r : 0) * stride + c, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                         int window, float scale, float softcap) {
  constexpr int LD = mma_ld<HD>();
  constexpr int TILE = kBQ * LD;
  constexpr int KS = HD / 16;        // k-steps of QK^T
  constexpr int NO = HD / 8;         // 8-wide output column tiles
  constexpr int NS = kBK / 8;        // 8-wide score column tiles
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TILE;     // 2 tiles
  __nv_bfloat16* Vs = Ks + 2 * TILE; // 2 tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  const int n_tiles = (S + kBK - 1) / kBK;
  const int kt_end = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  issue_tile<HD>(Qs, qb, q_stride, q0, S);
  issue_tile<HD>(Ks, kb, kv_stride, kt_begin * kBK, S);
  issue_tile<HD>(Vs, vb, kv_stride, kt_begin * kBK, S);
  cp_async_commit();

  // rows warp*16 + g (c = 0, 1) and + 8 (c = 2, 3) of the q tile
  uint32_t qf[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float c = softcap > 0.f ? kLog2e : scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {             // prefetch the next key tile
      issue_tile<HD>(Ks + (buf ^ 1) * TILE, kb, kv_stride, (kt + 1) * kBK, S);
      issue_tile<HD>(Vs + (buf ^ 1) * TILE, vb, kv_stride, (kt + 1) * kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;
    const int k0 = kt * kBK;

    // S = Q K^T: 16 x 64 per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // softcap, mask; online softmax per row (4 lanes share a row). Scores
    // stay in raw units (after the softcap); exp2 takes them times c.
    const bool masked = tile_needs_mask(q0, k0, S, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (softcap > 0.f) x = tanhf(x * cap_in) * softcap;
        if (masked && !visible(q0 + warp * 16 + g + (e >> 1) * 8,
                               k0 + n * 8 + 2 * t + (e & 1), S, window))
          x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mc[2];                       // the new max, times c
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no visible key yet keeps alpha = p = 0
      mc[i] = m_new == -INFINITY ? 0.f : m_new * c;
      const float alpha = ex2(fmaf(m[i], c, -mc[i]));
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], c, -mc[e >> 1]));
        s[n][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: P's accumulators are PV's A fragments, as hi + lo bf16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4], a_lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], a[0], a_lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], a[1], a_lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], a_lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], a_lo[3]);
      uint32_t r[NO / 2][4];
#pragma unroll
      for (int np = 0; np < NO / 2; ++np)
        ldmatrix_x4_trans(r[np], Vt + (kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * LD +
                                     np * 16 + (lane >> 4) * 8);
      // all hi products, then all lo: no accumulator is reused back to back
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        mma_bf16(o[2 * np], a, r[np][0], r[np][1]);
        mma_bf16(o[2 * np + 1], a, r[np][2], r[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        mma_bf16(o[2 * np], a_lo, r[np][0], r[np][1]);
        mma_bf16(o[2 * np + 1], a_lo, r[np][2], r[np][3]);
      }
    }
    __syncthreads();                   // this buffer is refilled next round
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + i * 8;
    if (qi >= S) continue;
    __nv_bfloat16* orow = out + (size_t)b * S * q_stride +
                          (size_t)qi * q_stride + (size_t)h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * i] * l[i], o[n][2 * i + 1] * l[i]);
  }
}

// ============================================= bf16: wgmma, hd 64, 128, 256

// Query heads of a CTA at hd 128, one warpgroup each (chosen by
// measuring, see the note above; hd 256 takes two): 2 shares each K/V tile
// between two heads, 1 lets two CTAs share an SM
constexpr int kWide128Heads = 1;
template <int HD>  // bytes of a 64 x HD tile
__host__ __device__ constexpr int wide_tile() {
  return HD / 64 * kWgTile;
}
// Q of each head | K ring (2) | V ring (2), plus room to align the base to
// 1024 bytes: 197,632 bytes at hd 256 with two heads, 99,328 at hd 128
// with two, 82,944 with one
template <int HD, int kHeads>
constexpr size_t wide_smem_bytes() {
  return (kHeads + 4) * (size_t)wide_tile<HD>() + 1024;
}
// the launch bounds' CTAs an SM: four at hd 64 (128 registers a thread),
// two one-head CTAs at hd 128; else one
template <int HD, int kHeads>
__host__ __device__ constexpr int wide_min_ctas() {
  return HD == 64 ? 4 : HD == 128 && kHeads == 1 ? 2 : 1;
}

// Two fp32 values as bf16 pairs hi + lo, as split_bf16 (wgmma.cuh) but with
// hi their top 16 bits (a byte permute, no rounding) and lo the exact
// residual rounded: one conversion a pair instead of two; hi + lo carries
// 15 or more mantissa bits.
__device__ __forceinline__ void split_bf16_trunc(float x0, float x1,
                                                 uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                 x1 - __uint_as_float(u1 & 0xFFFF0000u));
}

// ---- the tensor memory accelerator (TMA) and its barriers
// A tile of 64 rows x HD columns lands as HD / 64 boxes of 64 x 64 bf16,
// each in the 128-byte swizzle of a `wgmma` sub-tile (wgmma.cuh): the map
// (B, S, N, HD) -> (HD, N, S, B) with boxes (64, 1, 64, 1), rows at or past
// S zero-filled by the hardware.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
// this thread's arrival (the barrier's one), expecting `bytes` of copies
// to complete on `bar`
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// Start the copy of rows [r0, r0+64) of head `head` of batch row `b` (a
// (B, S, N, HD) tensor through `map`) into the tile at `dst`, completing
// HD / 64 x 8 KB on `bar`.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int r0,
                                         int b) {
#pragma unroll
  for (int j = 0; j < HD / 64; ++j)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(dst + j * kWgTile), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(64 * j), "r"(head), "r"(r0), "r"(b), "r"(bar)
        : "memory");
}

// One CTA: kHeads (1 or 2) query heads of one KV head (heads 2p and 2p + 1
// of its group of G; at odd G the group's last CTA has one) at one
// 64-query tile. Warpgroup w owns head kHeads p + w: its 64 query rows and
// all HD output columns.
template <int HD, int kHeads>
__global__ void __launch_bounds__(kHeads * kThreads,
                                  wide_min_ctas<HD, kHeads>())
flash_prefill_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                          int window, float scale, float softcap) {
  constexpr int kWideTile = wide_tile<HD>();
  extern __shared__ uint4 smem_raw[];
  // Q | K_0, K_1 | V_0, V_1 landed
  __shared__ alignas(8) uint64_t bars[5];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;  // kHeads
  const uint32_t Ks = Qs + kHeads * kWideTile;                  // 2 tiles
  const uint32_t Vs = Ks + 2 * kWideTile;                       // 2 tiles

  const int G = H / KV, pairs = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.x / pairs, g0 = blockIdx.x % pairs * kHeads;
  // the CTA has a second head
  const bool two = kHeads == 2 && g0 + 1 < G;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int wg = threadIdx.x / kThreads;
  const int h = kvh * G + g0 + wg;       // past the group when !two
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
  const size_t q_stride = (size_t)H * HD;
  const uint32_t Qw = Qs + wg * kWideTile;
  const uint32_t bar_q = smem_addr(&bars[0]), bar_k = bar_q + 8,
                 bar_v = bar_q + 24;       // + 8 (i & 1): buffer i & 1

  const int n_tiles = (S + kBK - 1) / kBK;
  const int kt_end = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n = kt_end - kt_begin;       // key tiles of this q tile, >= 1

  // Q of each head (an unpaired second warpgroup computes on a copy of
  // the first head's and stores nothing: the products stay on one path,
  // which `wgmma` needs to overlap), K of the first key tile; one thread
  // issues every copy
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar_q, kHeads * kWideTile);
    tma_tile<HD>(Qs, &tm_q, bar_q, kvh * G + g0, q0, b);
    if (kHeads == 2)
      tma_tile<HD>(Qs + kWideTile, &tm_q, bar_q, kvh * G + g0 + two, q0, b);
    mbar_expect(bar_k, kWideTile);
    tma_tile<HD>(Ks, &tm_k, bar_k, kvh, kt_begin * kBK, b);
  }

  // accumulator element 4n + e: row warp*16 + g + (e / 2) * 8, column
  // 8n + 2t + e % 2 (the mma.sync layout, per 8-column block n)
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  uint32_t ph[4][4], pl[4][4];          // the last tile's P, hi + lo bf16
  const float c = softcap > 0.f ? kLog2e : scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

  // Step i scores key tile i and adds tile i - 1's P V: QK^T_i and
  // PV_{i-1} are issued together, and the softmax of tile i runs while
  // PV_{i-1} is in flight. K runs one tile ahead and V one step behind it
  // through two-tile rings. Step i starts with a barrier (every warp is
  // done with step i - 1's products, so the buffers of K_{i-1} and V_{i-2}
  // are free), one thread starts K_{i+1} and V_i into them, and every
  // thread waits for K_i and V_{i-1} (at hd 64 the barrier and the copies
  // come after the wait and the step's products are issued). Steps 0 (QK^T alone) and n (PV
  // alone) are peeled off, so that every step between commits both groups
  // unconditionally: ptxas serialises the products when it cannot tell
  // which group a wait leaves in flight.
  auto refill = [&](int i) {
    __syncthreads();
    if (threadIdx.x != 0) return;
    const int kt = kt_begin + i;
    if (i + 1 < n) {
      const uint32_t bar = bar_k + 8 * ((i + 1) & 1);
      mbar_expect(bar, kWideTile);
      tma_tile<HD>(Ks + ((i + 1) & 1) * kWideTile, &tm_k, bar, kvh,
                   (kt + 1) * kBK, b);
    }
    if (i < n) {
      const uint32_t bar = bar_v + 8 * (i & 1);
      mbar_expect(bar, kWideTile);
      tma_tile<HD>(Vs + (i & 1) * kWideTile, &tm_v, bar, kvh, kt * kBK, b);
    }
  };
  auto arrive = [&](int i) {            // K_i and V_{i-1} have landed
    if (i < n) mbar_wait(bar_k + 8 * (i & 1), (i >> 1) & 1);
    if (i > 0) mbar_wait(bar_v + 8 * ((i - 1) & 1), ((i - 1) >> 1) & 1);
  };
  // S = Q K^T (64 x 64): HD / 16 k-steps of 16 along hd, four in each
  // 64-column sub-tile
  auto qk = [&](int i, float (&s)[32]) {
    const uint32_t Kt = Ks + (i & 1) * kWideTile;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t at = (kk / 4) * kWgTile + (kk % 4) * 32;
      wg_ss(s, wg_desc(Qw + at), wg_desc(Kt + at), kk > 0);
    }
    wg_commit();
  };
  // O += P_i V_i (one m64nHDk16 a k-step of 16 keys), P as hi + lo bf16
  // A fragments; V's leading byte offset steps over its sub-tiles
  auto pv = [&](int i) {
    const uint32_t Vt = Vs + (i & 1) * kWideTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs(o, ph[kk], wg_desc(Vt + kk * 2048, kWgTile));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs(o, pl[kk], wg_desc(Vt + kk * 2048, kWgTile));
    wg_commit();
  };
  // softcap, mask; online softmax per row (4 lanes share a row): s becomes
  // P, alpha the rescale of the rows' sums
  auto softmax = [&](int i, float (&s)[32], float (&alpha)[2]) {
    const int k0 = (kt_begin + i) * kBK;
    const bool masked = tile_needs_mask(q0, k0, S, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e];
      if (softcap > 0.f) x = tanhf(x * cap_in) * softcap;
      if (masked && !visible(q0 + warp * 16 + g + ((e >> 1) & 1) * 8,
                             k0 + (e >> 2) * 8 + 2 * t + (e & 1), S, window))
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
      // a row with no visible key yet keeps alpha = p = 0
      mc[r] = m_new == -INFINITY ? 0.f : m_new * c;
      alpha[r] = ex2(fmaf(m[r], c, -mc[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = ex2(fmaf(s[e], c, -mc[(e >> 1) & 1]));
      s[e] = p;
      l[(e >> 1) & 1] += p;
    }
  };
  // with no product in flight: rescale o, split P into the next PV's A
  // fragments (k-step kk covers keys 16kk .. 16kk+15)
  auto rescale_split = [&](const float (&s)[32], const float (&alpha)[2]) {
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * nn + 2 * r] *= alpha[r];
        o[4 * nn + 2 * r + 1] *= alpha[r];
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p0 = s + 8 * kk;      // 8-column block 2kk
      const float* p1 = s + 8 * kk + 4;  // 8-column block 2kk + 1
      split_bf16_trunc(p0[0], p0[1], ph[kk][0], pl[kk][0]);
      split_bf16_trunc(p0[2], p0[3], ph[kk][1], pl[kk][1]);
      split_bf16_trunc(p1[0], p1[1], ph[kk][2], pl[kk][2]);
      split_bf16_trunc(p1[2], p1[3], ph[kk][3], pl[kk][3]);
    }
  };

  {                                     // step 0: QK^T_0 alone
    float s[32], alpha[2];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    refill(0);
    mbar_wait(bar_q, 0);
    arrive(0);
    wg_fence();
    qk(0, s);
    wg_wait<0>();
    wg_fence_regs(s);
    softmax(0, s, alpha);
    rescale_split(s, alpha);
  }
  for (int i = 1; i < n; ++i) {
    float s[32], alpha[2];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    if constexpr (HD != 64) refill(i);
    arrive(i);
    wg_fence();
    if constexpr (HD == 64) {
      // four CTAs an SM: PV_{i-1} and QK^T_i run back to back and are
      // waited for together, so the softmax never holds P beside S and
      // 128 registers hold a thread; the next tiles' copies start once
      // the products are issued
      pv(i - 1);
      qk(i, s);
      refill(i);
      wg_wait<0>();
      wg_fence_regs(o);
      wg_fence_regs(ph);
      wg_fence_regs(pl);
      wg_fence_regs(s);
      softmax(i, s, alpha);
    } else {
      qk(i, s);
      pv(i - 1);
      wg_wait<1>();                     // S_i is in; PV_{i-1} runs on
      wg_fence_regs(s);
      softmax(i, s, alpha);
      wg_wait<0>();                     // PV_{i-1} is done with o and P
      wg_fence_regs(o);
      wg_fence_regs(ph);
      wg_fence_regs(pl);
    }
    rescale_split(s, alpha);
  }
  arrive(n);                            // step n: PV_{n-1} alone
  wg_fence();
  pv(n - 1);
  wg_wait<0>();
  wg_fence_regs(o);
  // O / l in bf16, staged in this warpgroup's Q tile (its products are
  // done) in the same swizzle (conflict-free), then stored as whole rows
  // of HD / 8 16-byte chunks
  const uint32_t Os = Qw;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      const uint32_t pair = pack_bf16(o[4 * nn + 2 * r] * l[r],
                                      o[4 * nn + 2 * r + 1] * l[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       Os + wg_tile_off(row, nn) + 4 * t), "r"(pair));
    }
  }
  // this warpgroup's 128 threads only
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kThreads));
  if (wg == 1 && !two) return;
  const int tw = threadIdx.x % kThreads;
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int j = 0; j < kBQ * kChunks / kThreads; ++j) {
    const int row = tw / kChunks + j * (kThreads / kChunks),
              ch = tw % kChunks;
    if (q0 + row >= S) break;
    uint4 chunk;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(chunk.x), "=r"(chunk.y), "=r"(chunk.z), "=r"(chunk.w)
                 : "r"(Os + wg_tile_off(row, ch)));
    *reinterpret_cast<uint4*>(out + (size_t)b * S * q_stride +
                              (size_t)(q0 + row) * q_stride + (size_t)h * HD +
                              ch * 8) = chunk;
  }
}

// ============================================================ fp32: CUDA cores

// Shared layout (floats): Qt (HD, BQ) | Kt (HD, BK) | Vs (BK, HD) | Pt (BK, BQ)
template <int HD>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)HD * kBQ + (size_t)HD * kBK +
                          (size_t)kBK * HD + (size_t)kBK * kBQ);
}

// Copy rows [r0, r0+n) of a (rows, HD) fp32 slab with row stride `stride`
// (elements) into shared memory, transposed (dst[d * ld + r]) or not
// (dst[r * ld + d]); rows at or past `limit` are zero-filled.
template <int HD, bool kTranspose>
__device__ void load_tile(const float* __restrict__ base, size_t stride,
                          int r0, int n, int limit, float* dst, int ld) {
  constexpr int V = Vec<float>::n;
  constexpr int per_row = HD / V;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    float e[V];
    if (r0 + r < limit) {
      load_vec(base + (size_t)(r0 + r) * stride + c, e);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) e[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (kTranspose) dst[(c + u) * ld + r] = e[u];
      else dst[r * ld + c + u] = e[u];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int S, int H, int KV, int window, float scale,
                          float softcap) {
  constexpr int NC = HD / 32;            // 4-wide output column chunks
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                      // (HD, BQ)
  float* Kt = Qt + HD * kBQ;             // (HD, BK)
  float* Vs = Kt + HD * kBK;             // (BK, HD)
  float* Pt = Vs + kBK * HD;             // (BK, BQ)

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;  // rows rg*4..+3; cols cg*4+{0..3}, +32
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const float* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  load_tile<HD, true>(qb, q_stride, q0, kBQ, S, Qt, kBQ);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  // Tiles the causal/window mask leaves any query of this CTA: skip the rest.
  const int n_tiles = (S + kBK - 1) / kBK;
  const int kt_end = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // previous tile fully consumed
    load_tile<HD, true>(kb, kv_stride, k0, kBK, S, Kt, kBK);
    load_tile<HD, false>(vb, kv_stride, k0, kBK, S, Vs, HD);
    __syncthreads();

    // S micro-tile: rows rg*4+i, columns cg*4+u and 32+cg*4+u
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + rg * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * kBK + cg * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Kt + d * kBK + 32 + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // scale, softcap, mask; online softmax across the 8 lanes of a row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = visible(qi, kj, S, window) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4;
      *reinterpret_cast<float4*>(Pt + col * kBQ + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc(rows, cols) += P(rows, :) V(:, cols); cols = c*32 + cg*4 + u
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * kBQ + rg * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * HD + c * 32 + cg * 4);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][c * 4 + u] = fmaf(pv[i], vf[u], acc[i][c * 4 + u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + (size_t)b * S * q_stride + (size_t)qi * q_stride +
                  (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        orow[c * 32 + cg * 4 + u] = acc[i][c * 4 + u] * inv;
  }
}

// ============================================================ launch

// `heads` CTAs along x: one a query head (hd 32 in bf16, fp32).
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int heads,
                   const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int hd, int window,
                   float softcap, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // q tiles slowest, so the whole grid runs the heaviest tiles first
  dim3 grid(heads, B, (S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, window,
      1.0f / sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda), looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a (B, S, N, HD) bf16 tensor for tma_tile.
template <int HD>
bool tile_map(CUtensorMap* map, const void* base, int B, int S, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * N, 2ull * HD * N * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 hd-64, hd-128 and hd-256 route: maps of q, k and v, then
// KV * ceil(G / kHeads) CTAs along x.
template <int HD, int kHeads>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KV, int window,
                        float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tile_map<HD>(&tq, q, B, S, H) || !tile_map<HD>(&tk, k, B, S, KV) ||
      !tile_map<HD>(&tv, v, B, S, KV))
    return cudaErrorInvalidValue;
  auto kernel = flash_prefill_wide_kernel<HD, kHeads>;
  constexpr size_t smem = wide_smem_bytes<HD, kHeads>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV * ((H / KV + kHeads - 1) / kHeads), B, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kHeads * kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, KV, window,
      1.0f / sqrtf((float)HD), softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int KV, int hd, int window,
                                    float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  using bf16 = __nv_bfloat16;
  if (S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 ||
      (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && hd == 64)
    return (int)launch_wide<64, 1>(q, k, v, out, B, S, H, KV, window,
                                   softcap, s);
  if (dtype == kBFloat16 && hd == 128)
    return (int)launch_wide<128, kWide128Heads>(q, k, v, out, B, S, H, KV,
                                                window, softcap, s);
  if (dtype == kBFloat16 && hd == 256)
    return (int)launch_wide<256, 2>(q, k, v, out, B, S, H, KV, window,
                                    softcap, s);
#define REPRO_PREFILL_SIMT(HD)                                               \
  if (dtype == kFloat32 && hd == HD)                                         \
    return (int)launch<float>(flash_prefill_simt_kernel<HD>,                 \
                              simt_smem_bytes<HD>(), kThreads, H, q, k, v,   \
                              out, B, S, H, KV, hd, window, softcap, s);
#define REPRO_PREFILL_HD(HD)                                                 \
  if (dtype == kBFloat16 && hd == HD)                                        \
    return (int)launch<bf16>(flash_prefill_mma_kernel<HD>,                   \
                             mma_smem_bytes<HD>(), kThreads, H, q, k, v,     \
                             out, B, S, H, KV, hd, window, softcap, s);      \
  REPRO_PREFILL_SIMT(HD)
  REPRO_PREFILL_HD(32)
  REPRO_PREFILL_SIMT(128)
  REPRO_PREFILL_SIMT(256)
  REPRO_PREFILL_SIMT(64)
#undef REPRO_PREFILL_HD
#undef REPRO_PREFILL_SIMT
  return (int)cudaErrorInvalidValue;
}

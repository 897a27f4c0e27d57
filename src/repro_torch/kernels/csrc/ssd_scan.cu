// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_chunked` (`_ssd_kernel`) of
// src/repro/kernels/ssd_scan.py. For each (batch row, head), over chunks
// of q steps, in fp32 inside:
//   dA = dt * A, cs = inclusive cumsum of dA in the chunk;
//   y[l]  = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) dt_s x_s   (diagonal)
//         + exp(cs_l) (C_l . state)                           (carried)
//   state <- exp(cs_last) state + sum_s exp(cs_last - cs_s) dt_s x_s (x) B_s
// y is written in x's dtype, the final state in fp32. B and C are shared by
// all heads (ngroups = 1).
//
// Layouts: x (b,s,h,p) and B, C (b,s,n) are read through their batch and
// step strides (each (batch, step) row packed, 16-byte aligned: the wrapper
// refuses anything else), so the model passes views of its conv output
// without copies; dt (b,s,h), A (h,), the initial state (b,h,p,n; null =
// zeros) and both outputs are packed. The TPU kernel needs s % q == 0 and
// the model pads; here a ragged last chunk is masked in-kernel (its missing
// steps load as dt = 0, x = B = C = 0, which leave the state unchanged, and
// their y is not written). Any q from 1 to 128 works.
//
// What bounds it on this card: bytes. At the serve path's shape (mamba2-130m,
// b=8, s=512, h=24, p=64, n=128, q=128, bf16 x/B/C/y, fp32 dt and states)
// the function moves ~40 MB (~12 us at 3.35 TB/s) against ~4 GFLOP of
// contractions (~4 us on the bf16 tensor cores). The TPU kernel walks the
// chunks in order with the state in VMEM; one CTA per (row, head) doing the
// same here gave 192 CTAs on 132 SMs, one 211 KB CTA per SM, C.B recomputed
// by every head and fp32 products on the CUDA cores (0.92 ms).
//
// What this design does about it: Mamba-2's own split of the scan into
// chunk-parallel work and a short sequential pass over chunk states, three
// launches per call (8 warps each), all on the caller's stream, with scratch
// from the wrapper's per-stream workspace (chunk states (b, nc, h, p, n)
// fp32, C.B (b, nc, QP, QP) fp32 with QP = q rounded up to 16, chunk decays
// (b, nc, h)):
//   1. ssd_scan_chunk_kernel, grid (h + 1, nc, b): CTA (head, chunk, row)
//      forms the cumsum and the chunk's local end state x'^T B (p x n,
//      depth q) with x' = x dt exp(cs_last - cs); the extra CTA (h, chunk,
//      row) forms C.B (q x q, depth n) once for all heads of the row, each
//      warp 16 rows up to their diagonal block.
//   2. ssd_scan_pass_kernel, grid (p n / 1024, h, b): the nc-step recurrence
//      state <- exp(cs_last) state + local, elementwise on float4s; it
//      overwrites each chunk's local state with the state BEFORE the chunk
//      and writes the final state.
//   3. ssd_scan_out_kernel, grid (h, nc, b): one warp per 16 output rows,
//      y = exp(cs_l) (C . state_before^T) + (C.B o decay o dt) . x, C.B
//      read from L2 two k-steps ahead of its use.
// At mamba2's serve shape that is 800, 1536 and 768 CTAs; shared memory 71
// KB for launch 1 and 89 KB for launch 3 (two CTAs per SM). The chunk
// states cost ~100 MB of traffic beside the ~40 MB the function must move,
// so the bound above is out of reach by design; launch 3 (each warp's
// chain of up to 8 diagonal k-steps, C.B from L2) takes half the time.
//
// bf16: every product runs on the tensor cores as `mma.sync.m16n8k16` with
// fp32 accumulation, fed by `ldmatrix` from padded (16-byte skewed) rows:
// C.B (C and B from shared memory), x'^T B (x transposed by `ldmatrix`, x'
// formed in registers), C . state^T (state from shared memory), and
// (C.B o decay) . x (the decayed matrix formed in registers from C.B read
// out of L2, x transposed by `ldmatrix`). `mma.sync` rather than `wgmma`:
// three of the four products take an operand that is formed per element in
// registers from fp32 values (x', the decayed C.B, the split state), a
// chunk can be any q from 1 to 128 and p = 16 or 32 or n = 8 or 16
// narrower than a 64-row warpgroup tile, and the tensor cores are not what
// bounds the kernel (~8 GFLOP with the splits below, ~13 us at the
// `mma.sync` rate).
//
// Widths: p in {16, 32, 64} and n in {8, 16, 32, 64, 128}, every pair, in
// both dtypes. p = 16 is one 16-row block of the m16n8k16 fragments. n = 8
// is one 8-wide n tile, but a product over n takes depth 16: the bf16 rows
// of B, C and the split state are held NK = n rounded up to 16 wide in
// shared memory with the columns past n zero, so the depth-n products run
// one k-step over zeros, and launch 1's x'^T B computes an 8-wide tile of
// zeros beside the real one and does not store it. In fp32 a thread maps
// one p row (lanes along n) or one p column (launch 3): below p = 32 the
// rows or lanes past p idle.
//
// Precision. x, B and C are bf16 already, so they enter the products
// exactly; every fp32 operand (x' = x dt exp(cs_last - cs), the decayed C.B
// with dt folded in, the carried state) enters as two bf16 terms, its
// rounding and the residual's (`split_bf16`: 16 mantissa bits, each such
// product issued twice): a single bf16 rounding (2^-9) fails the 1e-4
// relative check of the final state. The decay is formed elementwise as
// exp(cs_l - cs_s) after the C.B product and selected (never multiplied) to
// 0 above the diagonal: cs reaches -1000 and below over a 128-step chunk at
// mamba2's A (log A in [0, log 16]) and softplus dt, so exp(-cs_s) alone
// overflows; the factors exp(cs_l) and exp(cs_last - cs_s) are <= 1 and are
// folded into rows or operands. The diagonal's decays take `ex2` of the
// difference times log2 e (2 ulp), which flushes results below 2^-126 to 0.
//
// fp32 keeps fp32 arithmetic on the CUDA cores under the same three
// launches (no TF32: the fp32 checks hold the kernel to 1e-4 relative of
// the plain version, and the fp32 model rungs must give the same greedy
// tokens with the kernels on and off): register micro-tiled products over
// fp32 rows in shared memory (rows padded to n+1 floats).
#include "wgmma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kQMax = 128;       // largest chunk (the warp cumsum: 4 rows/lane)
constexpr int kThreads = 256;    // every launch: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 32;          // fp32 output rows per tile: 8 warps x 4
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int pad16(int q) { return (q + 15) / 16 * 16; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory in bytes (the wrapper's `launch_plan` mirrors them).
// bf16 rows of n values are pad16(N) + 8 wide (zero past N, then the skew).
__host__ __device__ constexpr size_t chunk_smem_bf16(int P, int N, int q) {
  return 2 * (size_t)pad16(q) * (pad16(N) + 8 + imax(pad16(N) + 8, P + 8)) +
         4 * 3 * (size_t)pad16(q);
}
__host__ __device__ constexpr size_t out_smem_bf16(int P, int N, int q) {
  return 2 * ((size_t)pad16(q) * (pad16(N) + 8) +
              2 * (size_t)P * (pad16(N) + 8) + (size_t)pad16(q) * (P + 8)) +
         4 * 2 * (size_t)pad16(q);
}
__host__ __device__ constexpr size_t chunk_smem_f32(int P, int N, int q) {
  return 4 * ((size_t)q * (N + 1) + (size_t)q * imax(P, N + 1) + 3 * (size_t)q);
}
__host__ __device__ constexpr size_t out_smem_f32(int P, int N, int q) {
  return 4 * ((size_t)q * P + (size_t)q * (N + 1) + (size_t)P * (N + 1) +
              (size_t)kTR * q + 2 * (size_t)q);
}

// Warp-wide: cs[l] = inclusive cumsum of dts[l] * a over l < rows (<= 128,
// 4 rows per lane). dts is 0 past the chunk's valid steps, so cs[rows - 1]
// is the chunk's total.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             int rows, float* cs, int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int l = lane * 4 + u;
    run += l < rows ? dts[l] * a : 0.f;
    v[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float excl = incl - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int l = lane * 4 + u;
    if (l < rows) cs[l] = excl + v[u];
  }
}

// Load dt of head hh for the chunk's rows [0, rows): 0 at and past qv.
__device__ __forceinline__ void load_dt(float* dts, const float* dt,
                                        size_t row0, int H, int hh, int qv,
                                        int rows) {
  for (int l = threadIdx.x; l < rows; l += blockDim.x)
    dts[l] = l < qv ? dt[(row0 + l) * H + hh] : 0.f;
}

// Start the copy of rows [0, rows) of a bf16 slab with COLS columns (row
// stride `stride` elements, rows 16-byte aligned) into shared `dst` (row
// stride `ld`), each row COLSP >= COLS wide; rows at or past `valid` and
// columns at or past COLS are zero-filled.
template <int COLS, int COLSP = COLS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          long long stride, int valid,
                                          int rows) {
  constexpr int CH = COLSP / 8;    // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < valid && c < COLS;
    cp_async16(dst + r * ld + c, src + (ok ? r * stride + c : 0), ok);
  }
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return make_float2(__low2float(h), __high2float(h));
}

// ============================================================ bf16: launch 1

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, float* __restrict__ st_ws,
                      float* __restrict__ cb_ws, float* __restrict__ dec_ws,
                      int S, int H, int q, long long x_bs, long long x_row,
                      long long bc_bs, long long bc_row) {
  constexpr int NK = pad16(N);              // n as a product's depth
  constexpr int LDN = NK + 8, LDP = P + 8;  // bf16 per shared row
  const int QP = pad16(q);
  const int hh = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;     // accumulator row / column pair
  const int t0 = c * q, qv = min(q, S - t0);

  extern __shared__ uint4 smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);       // (QP, LDN)
  bf16* Ts = Bs + QP * LDN;                           // x (QP, LDP) or C
  float* dts = reinterpret_cast<float*>(Ts + QP * imax(LDN, LDP));
  float* cs = dts + QP;
  float* w = cs + QP;

  const long long bc0 = bi * bc_bs + t0 * bc_row;
  load_rows<N, NK>(Bs, LDN, Bm + bc0, bc_row, qv, QP);

  if (hh == H) {
    // ---- C.B (QP x QP, depth N) of this (row, chunk), for every head.
    // Warp w takes 16-row block w, and of it only the columns up to its
    // diagonal block (all that launch 3 reads).
    load_rows<N, NK>(Ts, LDN, Cm + bc0, bc_row, qv, QP);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float* cb = cb_ws + ((size_t)bi * nc + c) * QP * QP;
    const int mb = warp;
    if (mb < QP / 16) {
      for (int n0 = 0; n0 <= mb; n0 += 4) {   // 4 column blocks of 16
        const int npl = min(4, mb + 1 - n0);
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, Ts + (mb * 16 + (lane & 15)) * LDN + kk * 16 +
                             (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np < npl) {
              uint32_t r[4];
              ldmatrix_x4(r, Bs + ((n0 + np) * 16 + (lane & 7) +
                                   ((lane >> 4) << 3)) * LDN +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(acc[2 * np], a, r[0], r[1]);
              mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j / 2 < npl) {
            const int col = (n0 * 2 + j) * 8 + 2 * t;
            float* r0 = cb + (size_t)(mb * 16 + g) * QP + col;
            *reinterpret_cast<float2*>(r0) = make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(r0 + 8 * QP) =
                make_float2(acc[j][2], acc[j][3]);
          }
        }
      }
    }
    return;
  }

  // ---- the chunk's local end state (P x N) = x'^T B, x' = x w, depth QP
  const bf16* xb = x + bi * x_bs + t0 * x_row + (long long)hh * P;
  load_rows<P>(Ts, LDP, xb, x_row, qv, QP);
  cp_async_commit();
  load_dt(dts, dt, (size_t)bi * S + t0, H, hh, qv, QP);
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, A[hh], QP, cs, lane);
  __syncthreads();
  const float tot = cs[QP - 1];
  for (int l = threadIdx.x; l < QP; l += blockDim.x)
    w[l] = dts[l] * expf(tot - cs[l]);
  if (threadIdx.x == 0) dec_ws[((size_t)bi * nc + c) * H + hh] = expf(tot);
  cp_async_wait<0>();
  __syncthreads();

  constexpr int MB = P / 16;                          // 16-row blocks of p
  constexpr int NSPLIT = (kWarps / MB < NK / 16) ? kWarps / MB : NK / 16;
  constexpr int NT = NK / 8 / NSPLIT;                 // 8-wide n tiles/warp
  static_assert(NT % 2 == 0 && MB * NSPLIT <= kWarps, "unsupported (p, n)");
  if (warp >= MB * NSPLIT) return;
  const int mb = warp % MB, nt0 = (warp / MB) * NT;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < QP / 16; ++kk) {
    // A = x'^T: rows p, columns (depth) s; `ldmatrix.trans` of x's rows
    uint32_t a[4], ah[4], al[4];
    ldmatrix_x4_trans(a, Ts + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  LDP + mb * 16 + ((lane >> 3) & 1) * 8);
    const int k0 = kk * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = k0 + (i >= 2 ? 8 : 0);
      const float2 v = bf16x2_to_float2(a[i]);
      split_bf16(v.x * w[s], v.y * w[s + 1], ah[i], al[i]);
    }
    uint32_t r[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldmatrix_x4_trans(r[np], Bs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LDN +
                                   (nt0 + 2 * np) * 8 + (lane >> 4) * 8);
    // all hi products, then all lo: no accumulator is reused back to back
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_bf16(acc[2 * np], ah, r[np][0], r[np][1]);
      mma_bf16(acc[2 * np + 1], ah, r[np][2], r[np][3]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_bf16(acc[2 * np], al, r[np][0], r[np][1]);
      mma_bf16(acc[2 * np + 1], al, r[np][2], r[np][3]);
    }
  }
  float* sp = st_ws + (((size_t)bi * nc + c) * H + hh) * P * N +
              (size_t)(mb * 16 + g) * N + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if ((nt0 + j) * 8 >= N) continue;     // a tile of the zero columns
    float* r0 = sp + (nt0 + j) * 8;
    *reinterpret_cast<float2*>(r0) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(r0 + 8 * N) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ============================================================ launch 2

// Per (row, head), float4 e of the (P x N) state: walk the nc chunks,
// replacing each chunk's local end state with the state before the chunk.
__global__ void __launch_bounds__(kThreads)
ssd_scan_pass_kernel(float* __restrict__ st_ws,
                     const float* __restrict__ dec_ws,
                     const float* __restrict__ init, float* __restrict__ fin,
                     int H, int nc, int PN4) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN4) return;
  const int hh = blockIdx.y, bi = blockIdx.z;
  float4* st = reinterpret_cast<float4*>(st_ws);
  const size_t row = (size_t)bi * H + hh;
  float4 s = init ? reinterpret_cast<const float4*>(init)[row * PN4 + e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  auto at = [&](int c) { return (((size_t)bi * nc + c) * H + hh) * PN4 + e; };
  float4 v = st[at(0)];
  for (int c = 0; c < nc; ++c) {
    const float4 nxt = c + 1 < nc ? st[at(c + 1)] : v;   // in flight early
    const float d = dec_ws[((size_t)bi * nc + c) * H + hh];
    st[at(c)] = s;
    s = make_float4(s.x * d + v.x, s.y * d + v.y, s.z * d + v.z,
                    s.w * d + v.w);
    v = nxt;
  }
  reinterpret_cast<float4*>(fin)[row * PN4 + e] = s;
}

// ============================================================ bf16: launch 3

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Cm,
                    const float* __restrict__ st_ws,
                    const float* __restrict__ cb_ws, bf16* __restrict__ y,
                    int S, int H, int q, long long x_bs, long long x_row,
                    long long bc_bs, long long bc_row) {
  constexpr int NK = pad16(N);
  constexpr int LDN = NK + 8, LDP = P + 8;
  const int QP = pad16(q);
  const int hh = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int t0 = c * q, qv = min(q, S - t0);
  const size_t row0 = (size_t)bi * S + t0;

  extern __shared__ uint4 smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);   // (QP, LDN)
  bf16* Sh = Cs + QP * LDN;                       // (P, LDN) state, bf16 hi
  bf16* Sl = Sh + P * LDN;                        // (P, LDN) its residual
  bf16* Xs = Sl + P * LDN;                        // (QP, LDP)
  float* dts = reinterpret_cast<float*>(Xs + QP * LDP);
  float* cs = dts + QP;

  load_rows<N, NK>(Cs, LDN, Cm + bi * bc_bs + t0 * bc_row, bc_row, qv, QP);
  load_rows<P>(Xs, LDP, x + bi * x_bs + t0 * x_row + (long long)hh * P,
               x_row, qv, QP);
  cp_async_commit();
  {   // the state before this chunk as hi + lo bf16 (all loads in flight)
    constexpr int V = P * N / 4, SV = (V + kThreads - 1) / kThreads;
    const float4* sp = reinterpret_cast<const float4*>(
        st_ws + (((size_t)bi * nc + c) * H + hh) * P * N);
    float4 v[SV];
#pragma unroll
    for (int u = 0; u < SV; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < V) v[u] = sp[e];
    }
#pragma unroll
    for (int u = 0; u < SV; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e >= V) continue;
      const int r = e * 4 / N, col = e * 4 % N;
      uint32_t h0, l0, h1, l1;
      split_bf16(v[u].x, v[u].y, h0, l0);
      split_bf16(v[u].z, v[u].w, h1, l1);
      *reinterpret_cast<uint2*>(Sh + r * LDN + col) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(Sl + r * LDN + col) = make_uint2(l0, l1);
    }
    if constexpr (NK > N) {   // the zero columns of the depth-NK product
      for (int e = threadIdx.x; e < P * (NK - N); e += kThreads) {
        const int r = e / (NK - N), col = N + e % (NK - N);
        Sh[r * LDN + col] = Sl[r * LDN + col] = __float2bfloat16(0.f);
      }
    }
  }
  load_dt(dts, dt, row0, H, hh, qv, QP);
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, A[hh], QP, cs, lane);
  cp_async_wait<0>();
  __syncthreads();

  const int mb = warp, l0 = mb * 16;              // this warp's 16 rows
  if (l0 >= qv) return;
  const int la = l0 + g, lb = la + 8;
  const float* cba = cb_ws + ((size_t)bi * nc + c) * QP * QP + (size_t)la * QP;
  const float* cbb = cba + 8 * QP;
  // this thread's C.B values of k-step kk: rows la, lb; columns s, s + 1
  // and s + 8, s + 9 (the A fragment's layout). A ring of three, two
  // k-steps ahead; the first two are in flight during the carried product.
  float2 cv[3][4];
  auto fetch = [&](float2 (&f)[4], int kk) {
    const int s = kk * 16 + 2 * t;
    f[0] = __ldg(reinterpret_cast<const float2*>(cba + s));
    f[1] = __ldg(reinterpret_cast<const float2*>(cbb + s));
    f[2] = __ldg(reinterpret_cast<const float2*>(cba + s + 8));
    f[3] = __ldg(reinterpret_cast<const float2*>(cbb + s + 8));
  };
  fetch(cv[0], 0);
  if (mb >= 1) fetch(cv[1], 1);

  float acc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // carried: C_l . state^T (depth N), the state as hi + lo
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Cs + (l0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                      kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t rh[4], rl[4];
      ldmatrix_x4(rh, Sh + off);
      ldmatrix_x4(rl, Sl + off);
      mma_bf16(acc[2 * np], a, rh[0], rh[1]);
      mma_bf16(acc[2 * np + 1], a, rh[2], rh[3]);
      mma_bf16(acc[2 * np], a, rl[0], rl[1]);
      mma_bf16(acc[2 * np + 1], a, rl[2], rl[3]);
    }
  }
  const float csa = cs[la], csb = cs[lb];
  const float ea = expf(csa), eb = expf(csb);
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    acc[j][0] *= ea;
    acc[j][1] *= ea;
    acc[j][2] *= eb;
    acc[j][3] *= eb;
  }

  // diagonal: M = C.B o exp(cs_l - cs_s) o dt_s (s <= l, else 0) times x,
  // over the k-steps up to this warp's diagonal block
  // (unrolled over the largest chunk's 8 k-steps: the ring's indices are
  // compile-time, so it stays in registers)
#pragma unroll
  for (int kk = 0; kk < kQMax / 16; ++kk) {
    if (kk > mb) break;
    if (kk + 2 <= mb) fetch(cv[(kk + 2) % 3], kk + 2);
    const float2 (&cf)[4] = cv[kk % 3];
    const int s0 = kk * 16 + 2 * t;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // fragment register i: row la (i even) or lb, columns s, s + 1
      const int l = (i & 1) ? lb : la;
      const float csl = (i & 1) ? csb : csa;
      const int s = s0 + (i >= 2 ? 8 : 0);
      const float m0 =
          s <= l ? cf[i].x * ex2((csl - cs[s]) * kLog2e) * dts[s] : 0.f;
      const float m1 = s + 1 <= l
          ? cf[i].y * ex2((csl - cs[s + 1]) * kLog2e) * dts[s + 1] : 0.f;
      split_bf16(m0, m1, ah[i], al[i]);
    }
    uint32_t r[P / 16][4];
#pragma unroll
    for (int np = 0; np < P / 16; ++np)
      ldmatrix_x4_trans(r[np], Xs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LDP +
                                   np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      mma_bf16(acc[2 * np], ah, r[np][0], r[np][1]);
      mma_bf16(acc[2 * np + 1], ah, r[np][2], r[np][3]);
    }
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      mma_bf16(acc[2 * np], al, r[np][0], r[np][1]);
      mma_bf16(acc[2 * np + 1], al, r[np][2], r[np][3]);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = half ? lb : la;
    if (l >= qv) continue;
    bf16* yr = y + ((row0 + l) * H + hh) * P + 2 * t;
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
      *reinterpret_cast<uint32_t*>(yr + j * 8) =
          pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// ============================================================ fp32: launch 1

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          float* __restrict__ st_ws, float* __restrict__ cb_ws,
                          float* __restrict__ dec_ws, int S, int H, int q,
                          long long x_bs, long long x_row, long long bc_bs,
                          long long bc_row) {
  constexpr int LDN = N + 1;            // padded row of B and C
  // state mapping: lanes along n, warps (and lane halves) along p
  constexpr int KL = N < 32 ? N : 32;
  constexpr int RPW = 32 / KL;
  constexpr int KJ = N / KL;
  constexpr int PI = (P + kWarps * RPW - 1) / (kWarps * RPW);
  static_assert(P % 16 == 0 && N % KL == 0 &&
                (P % (kWarps * RPW) == 0 || PI == 1), "unsupported (p, n)");
  const int QP = pad16(q);
  const int hh = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * q, qv = min(q, S - t0);

  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // (q, LDN)
  float* Ts = Bs + q * LDN;                      // x dt (q, P) or C (q, LDN)
  float* dts = Ts + q * imax(P, LDN);
  float* cs = dts + q;
  float* wv = cs + q;                            // exp(cs_last - cs_s)

  const long long bc0 = bi * bc_bs + t0 * bc_row;
  for (int e = tid; e < q * N; e += kThreads) {
    const int l = e / N, k = e % N;
    Bs[l * LDN + k] = l < qv ? Bm[bc0 + l * bc_row + k] : 0.f;
  }
  if (hh == H) {
    // ---- C.B (s <= l) of this (row, chunk), 32 rows at a time: warp w
    // rows 4w .. 4w+3 of the tile, lanes along s
    for (int e = tid; e < q * N; e += kThreads) {
      const int l = e / N, k = e % N;
      Ts[l * LDN + k] = l < qv ? Cm[bc0 + l * bc_row + k] : 0.f;
    }
    __syncthreads();
    float* cb = cb_ws + ((size_t)bi * nc + c) * QP * QP;
    const int r0 = warp * 4;
    for (int l0 = 0; l0 < qv; l0 += kTR) {
      const int ncol = min(qv, l0 + kTR);
      const int jmax = (ncol + 31) / 32;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      int lr[4], sc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lr[i] = min(l0 + r0 + i, q - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = min(lane + 32 * j, q - 1);
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ts[lr[i] * LDN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = j < jmax ? Bs[sc[j] * LDN + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = lane + 32 * j;
          if (l < qv && s <= l) cb[(size_t)l * QP + s] = acc[i][j];
        }
      }
    }
    return;
  }

  // ---- the chunk's local end state: sum_s exp(cs_last - cs_s) xdt_s (x) B_s
  const size_t row0 = (size_t)bi * S + t0;
  const float* xb = x + bi * x_bs + t0 * x_row + (long long)hh * P;
  load_dt(dts, dt, row0, H, hh, qv, q);
  __syncthreads();
  for (int e = tid; e < q * P; e += kThreads) {
    const int l = e / P, pi = e % P;
    Ts[e] = l < qv ? xb[l * x_row + pi] * dts[l] : 0.f;
  }
  if (warp == 0) chunk_cumsum(dts, A[hh], q, cs, lane);
  __syncthreads();
  const float tot = cs[q - 1];
  for (int l = tid; l < q; l += kThreads) wv[l] = expf(tot - cs[l]);
  if (tid == 0) dec_ws[((size_t)bi * nc + c) * H + hh] = expf(tot);
  __syncthreads();
  const int kl = lane % KL, pr = lane / KL;
  // this thread's p rows; past P (only where P < kWarps * RPW) they idle
  int prow[PI];
#pragma unroll
  for (int ii = 0; ii < PI; ++ii) prow[ii] = pr + RPW * (warp + kWarps * ii);
  float acc[PI][KJ];
#pragma unroll
  for (int ii = 0; ii < PI; ++ii)
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) acc[ii][jj] = 0.f;
  for (int s = 0; s < qv; ++s) {
    const float w = wv[s];
    float xv[PI], bv[KJ];
#pragma unroll
    for (int ii = 0; ii < PI; ++ii)
      xv[ii] = prow[ii] < P ? Ts[s * P + prow[ii]] * w : 0.f;
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) bv[jj] = Bs[s * LDN + kl + KL * jj];
#pragma unroll
    for (int ii = 0; ii < PI; ++ii)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj)
        acc[ii][jj] = fmaf(xv[ii], bv[jj], acc[ii][jj]);
  }
  float* sp = st_ws + (((size_t)bi * nc + c) * H + hh) * P * N;
#pragma unroll
  for (int ii = 0; ii < PI; ++ii)
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj)
      if (prow[ii] < P) sp[prow[ii] * N + kl + KL * jj] = acc[ii][jj];
}

// ============================================================ fp32: launch 3

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_out_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Cm,
                        const float* __restrict__ st_ws,
                        const float* __restrict__ cb_ws, float* __restrict__ y,
                        int S, int H, int q, long long x_bs, long long x_row,
                        long long bc_bs, long long bc_row) {
  constexpr int LDN = N + 1;
  constexpr int PJ = (P + 31) / 32;     // output columns per thread
  // a lane's columns lane + 32 j, clamped to P - 1 for loads; stored only
  // below P (at P = 16 the upper half-warp computes a copy and drops it)
  int pc[PJ];
#pragma unroll
  for (int j = 0; j < PJ; ++j) pc[j] = min(threadIdx.x % 32 + 32 * j, P - 1);
  const int QP = pad16(q);
  const int hh = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * q, qv = min(q, S - t0);
  const size_t row0 = (size_t)bi * S + t0;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // (q, P) x * dt
  float* Cs = xs + q * P;                        // (q, LDN)
  float* st = Cs + q * LDN;                      // (P, LDN) state before
  float* Mt = st + P * LDN;                      // (kTR, q) decayed C.B tile
  float* cs = Mt + kTR * q;
  float* dts = cs + q;

  const float* xb = x + bi * x_bs + t0 * x_row + (long long)hh * P;
  const long long bc0 = bi * bc_bs + t0 * bc_row;
  const float* sp = st_ws + (((size_t)bi * nc + c) * H + hh) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    st[(e / N) * LDN + e % N] = sp[e];
  for (int e = tid; e < q * N; e += kThreads) {
    const int l = e / N, k = e % N;
    Cs[l * LDN + k] = l < qv ? Cm[bc0 + l * bc_row + k] : 0.f;
  }
  load_dt(dts, dt, row0, H, hh, qv, q);
  __syncthreads();
  for (int e = tid; e < q * P; e += kThreads) {
    const int l = e / P, pi = e % P;
    xs[e] = l < qv ? xb[l * x_row + pi] * dts[l] : 0.f;
  }
  if (warp == 0) chunk_cumsum(dts, A[hh], q, cs, lane);
  __syncthreads();

  const float* cb = cb_ws + ((size_t)bi * nc + c) * QP * QP;
  const int r0 = warp * 4;              // this warp's 4 rows of the tile
  for (int l0 = 0; l0 < qv; l0 += kTR) {
    const int ncol = min(qv, l0 + kTR); // causal: columns s < ncol
    // Mt[r][s] = (C_l . B_s) exp(cs_l - cs_s) for s <= l, else 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane + 32 * j;
        if (s < ncol)
          Mt[(r0 + i) * q + s] = (l < qv && s <= l)
              ? cb[(size_t)l * QP + s] * expf(cs[l] - cs[s]) : 0.f;
      }
    }
    __syncthreads();
    // y = Mt . xdt + exp(cs_l) (C_l . state)
    float acc[4][PJ], off[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = off[i][j] = 0.f;
    for (int s = 0; s < ncol; ++s) {
      float m[4], xv[PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = Mt[(r0 + i) * q + s];
#pragma unroll
      for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + pc[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(m[i], xv[j], acc[i][j]);
    }
    int lr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lr[i] = min(l0 + r0 + i, q - 1);
    for (int k = 0; k < N; ++k) {
      float cv[4], sv[PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Cs[lr[i] * LDN + k];
#pragma unroll
      for (int j = 0; j < PJ; ++j) sv[j] = st[pc[j] * LDN + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + r0 + i;
      if (l >= qv) continue;
      const float e = expf(cs[l]);
      float* yr = y + ((row0 + l) * H + hh) * P;
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        if (lane + 32 * j < P) yr[lane + 32 * j] = acc[i][j] + e * off[i][j];
    }
    __syncthreads();                    // Mt is rewritten by the next tile
  }
}

// ============================================================ launches

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* fin, float* ws, int b, int S, int H, int q,
                   long long x_bs, long long x_row, long long bc_bs,
                   long long bc_row, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int QP = pad16(q), nc = (S + q - 1) / q;
  float* st = ws;                                   // (b, nc, H, P, N)
  float* cb = st + (size_t)b * nc * H * P * N;      // (b, nc, QP, QP)
  float* dec = cb + (size_t)b * nc * QP * QP;       // (b, nc, H)
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(Bm);
  const T* cp = static_cast<const T*>(Cm);
  const dim3 grid1(H + 1, nc, b), grid3(H, nc, b);
  cudaError_t err;
  if constexpr (kBf16) {
    const size_t s1 = chunk_smem_bf16(P, N, q), s3 = out_smem_bf16(P, N, q);
    if ((err = allow_smem(ssd_scan_chunk_kernel<P, N>, s1)) != cudaSuccess ||
        (err = allow_smem(ssd_scan_out_kernel<P, N>, s3)) != cudaSuccess)
      return err;
    ssd_scan_chunk_kernel<P, N><<<grid1, kThreads, s1, stream>>>(
        xp, dt, A, bp, cp, st, cb, dec, S, H, q, x_bs, x_row, bc_bs, bc_row);
  } else {
    const size_t s1 = chunk_smem_f32(P, N, q), s3 = out_smem_f32(P, N, q);
    if ((err = allow_smem(ssd_scan_chunk_f32_kernel<P, N>, s1)) !=
            cudaSuccess ||
        (err = allow_smem(ssd_scan_out_f32_kernel<P, N>, s3)) != cudaSuccess)
      return err;
    ssd_scan_chunk_f32_kernel<P, N><<<grid1, kThreads, s1, stream>>>(
        xp, dt, A, bp, cp, st, cb, dec, S, H, q, x_bs, x_row, bc_bs, bc_row);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int PN4 = P * N / 4;
  ssd_scan_pass_kernel<<<dim3((PN4 + kThreads - 1) / kThreads, H, b),
                         kThreads, 0, stream>>>(st, dec, init, fin, H, nc,
                                                PN4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (kBf16) {
    ssd_scan_out_kernel<P, N><<<grid3, kThreads, out_smem_bf16(P, N, q),
                                stream>>>(xp, dt, A, cp, st, cb,
                                          static_cast<T*>(y), S, H, q, x_bs,
                                          x_row, bc_bs, bc_row);
  } else {
    ssd_scan_out_f32_kernel<P, N><<<grid3, kThreads, out_smem_f32(P, N, q),
                                    stream>>>(xp, dt, A, cp, st, cb,
                                              static_cast<T*>(y), S, H, q,
                                              x_bs, x_row, bc_bs, bc_row);
  }
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fin, float* ws, int b, int S, int H,
                       int n, int q, long long x_bs, long long x_row,
                       long long bc_bs, long long bc_row, cudaStream_t s) {
#define SSD_CASE(NN)                                                        \
  if (n == NN)                                                              \
    return launch<T, P, NN>(x, dt, A, Bm, Cm, init, y, fin, ws, b, S, H, q, \
                            x_bs, x_row, bc_bs, bc_row, s);
  SSD_CASE(8)
  SSD_CASE(16)
  SSD_CASE(32)
  SSD_CASE(64)
  SSD_CASE(128)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_p(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fin, float* ws, int b, int S, int H,
                       int p, int n, int q, long long x_bs, long long x_row,
                       long long bc_bs, long long bc_row, cudaStream_t s) {
  if (p == 16)
    return dispatch_n<T, 16>(x, dt, A, Bm, Cm, init, y, fin, ws, b, S, H, n,
                             q, x_bs, x_row, bc_bs, bc_row, s);
  if (p == 32)
    return dispatch_n<T, 32>(x, dt, A, Bm, Cm, init, y, fin, ws, b, S, H, n,
                             q, x_bs, x_row, bc_bs, bc_row, s);
  if (p == 64)
    return dispatch_n<T, 64>(x, dt, A, Bm, Cm, init, y, fin, ws, b, S, H, n,
                             q, x_bs, x_row, bc_bs, bc_row, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). `init` may be null (zero initial state); `ws` holds
// the wrapper's `launch_plan` workspace floats. Returns the cudaError_t of
// the launches (0 = ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* fin, void* ws,
                               int b, int S, int H, int p, int n, int q,
                               long long x_bs, long long x_row,
                               long long bc_bs, long long bc_row, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (b <= 0 || S <= 0 || H <= 0 || q <= 0 || q > kQMax)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto dtp = static_cast<const float*>(dt);
  auto Ap = static_cast<const float*>(A);
  auto ip = static_cast<const float*>(init);
  auto fp = static_cast<float*>(fin);
  auto wp = static_cast<float*>(ws);
  if (dtype == kFloat32)
    return (int)dispatch_p<float>(x, dtp, Ap, Bm, Cm, ip, y, fp, wp, b, S, H,
                                  p, n, q, x_bs, x_row, bc_bs, bc_row, s);
  if (dtype == kBFloat16)
    return (int)dispatch_p<bf16>(x, dtp, Ap, Bm, Cm, ip, y, fp, wp, b, S, H,
                                 p, n, q, x_bs, x_row, bc_bs, bc_row, s);
  return (int)cudaErrorInvalidValue;
}

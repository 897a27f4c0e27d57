// Hopper tensor-core helpers shared by the kernels that run `wgmma` or
// `mma.sync` (flash_prefill.cu, flash_decode_chunk.cu, paged_decode.cu,
// ssd_scan.cu): fast exp2, bf16 packing with the hi + lo split, warp-level
// `mma.sync` fed by `ldmatrix`, and warpgroup matrix multiply from
// 128-byte-swizzled shared memory.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as a bf16 pair `hi` plus the bf16 pair of their rounding
// residuals `lo`: hi + lo carries 16 mantissa bits (relative error <= 2^-18).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---- warp-level tensor-core products (mma.sync) fed by ldmatrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warpgroup (the CTA's 4 warps) issues each product: QK^T as
// m64n64k16 with Q and K read from shared memory, PV as m64nNk16 (N = the
// head dim: 64, 128 or 256) with P from registers and V from shared
// memory. A tile of 64 rows and hd columns is stored as hd / 64 sub-tiles
// of 64 rows of 64 bf16 (128 bytes, 8 KB a sub-tile) in the 128-byte
// swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its
// sub-tile, so the tensor cores read them without bank conflicts.
constexpr int kWgTile = 64 * 128;            // bytes of one 64 x 64 sub-tile

// Byte offset of row r's 16-byte chunk c (of hd / 8) in a swizzled tile.
__device__ __forceinline__ uint32_t wg_tile_off(int r, int c) {
  return (c >> 3) * kWgTile + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle. Rows of one sub-tile are 128
// bytes apart, 8-row groups 1024 bytes apart (the stride offset). K-major
// tiles (Q, K) leave the leading offset unused: a k-step of 16 columns
// lies inside one sub-tile. V, read MN-major (keys along K, hd along N),
// steps by the leading offset `lbo` to its next 64-wide block of hd: the
// next sub-tile, kWgTile bytes on (at hd 64 there is none).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr,
                                            uint32_t lbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses to accumulators across a wait.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OPS32(d, o)                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
  "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),             \
  "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),           \
  "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]),         \
  "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),         \
  "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]),         \
  "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]),         \
  "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])
#define WG_D32_OPS(d) WG_OPS32(d, 0)
#define WG_D64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define WG_D64_OPS(d) WG_OPS32(d, 0), WG_OPS32(d, 32)
#define WG_D128                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127}"
#define WG_D128_OPS(d)                                                        \
  WG_OPS32(d, 0), WG_OPS32(d, 32), WG_OPS32(d, 64), WG_OPS32(d, 96)

// d (64x64 fp32; scale_d 0 overwrites) += A (smem, K-major) * B (smem,
// K-major)
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A (registers: this warp's 16 rows, the mma.sync A fragment) *
// B (smem, MN-major): m64n64k16, m64n128k16 or m64n256k16 by the width of
// d (hd / 2 accumulators a thread; element 4n + e is row warp*16 + lane/4
// + (e / 2) * 8, column 8n + 2 (lane % 4) + e % 2)
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_rs(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_rs(float (&d)[128],
                                      const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D128_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the split combine of the tensor-core chunk forms
// (flash_decode_chunk.cu, paged_decode.cu). This CTA has written its
// partial for a block of 64 query rows, acc (64, HD), then m (64), then l
// (64) in fp32, and every thread has fenced its own stores. Arrive on the
// block's counter; if last, combine the `splits` partials at `pb` into rows
// R0 .. R0+nr-1 of `out` ((B, ck, KV, G, HD) bf16, row = j*G + g): split s
// weighs 2^((m_s - M) * m_log2) / L, L the sum of its l_s so weighted,
// floored at 1e-30; then set the counter back to zero. What it costs is
// the latency of reading splits x 64 x HD floats from L2: m and l of every
// split are staged in shared memory by all threads at once (each m then
// overwritten by its split's weight), then each thread keeps 4 rows'
// 16-byte loads of up to 4 splits in flight. `smem` holds 2 * splits * 64
// floats (32 KB at the 64 splits the launchers allow).
template <int HD>
__device__ void wg_arrive_and_combine(const float* pb, int* counter,
                                      int splits, int nr, float m_log2,
                                      float* smem,
                                      __nv_bfloat16* __restrict__ out, int b,
                                      int h, int R0, int ck, int KV, int G) {
  constexpr int kR = 64, kQ = HD / 4, kU = 4;
  constexpr size_t kSplit = (size_t)kR * HD + 2 * kR;
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  float* w_s = smem;                   // (splits, 64): m, then weights
  float* l_s = w_s + splits * kR;      // (splits, 64)
  for (int i = threadIdx.x; i < splits * kR; i += blockDim.x) {
    const float* ml = pb + (size_t)(i / kR) * kSplit + (size_t)kR * HD;
    w_s[i] = __ldcg(ml + i % kR);
    l_s[i] = __ldcg(ml + kR + i % kR);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, w_s[s * kR + r]);
    for (int s = 0; s < splits; ++s) {
      const float w = ex2((w_s[s * kR + r] - M) * m_log2);
      w_s[s * kR + r] = w;
      L = fmaf(l_s[s * kR + r], w, L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < splits; ++s) w_s[s * kR + r] *= inv;
  }
  __syncthreads();
  // four columns an item: 16-byte partial reads, 8-byte output stores
  const int n = nr * kQ, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kU * step) {
    float4 O[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) O[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = min(i0 + u * step, n - 1);  // past n: read, not kept
        const int r = i / kQ, d = 4 * (i % kQ);
        const float4 a = __ldcg(
            reinterpret_cast<const float4*>(pb + s * kSplit + r * HD + d));
        const float w = w_s[s * kR + r];
        O[u].x = fmaf(a.x, w, O[u].x);
        O[u].y = fmaf(a.y, w, O[u].y);
        O[u].z = fmaf(a.z, w, O[u].z);
        O[u].w = fmaf(a.w, w, O[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * step;
      if (i >= n) break;
      const int row = R0 + i / kQ, d = 4 * (i % kQ);
      const int j = row / G, g = row % G;
      uint2 packed;
      packed.x = pack_bf16(O[u].x, O[u].y);
      packed.y = pack_bf16(O[u].z, O[u].w);
      *reinterpret_cast<uint2*>(
          out + ((((size_t)b * ck + j) * KV + h) * G + g) * HD + d) = packed;
    }
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

}  // namespace repro_torch

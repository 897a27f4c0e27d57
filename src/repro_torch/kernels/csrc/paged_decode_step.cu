// The paged decode step of GQA attention, bf16 at hd 64, 128 and 256, on
// Hopper's tensor cores (sm_90a): every paged model's decode step
// (tinyllama-1.1b, granite-moe-3b-a800m at hd 64; internvl2-26b, yi-6b at
// 128; gemma-2b at 256) and the speculative drafter's paged steps.
//
// Replaces, at these head dims, the TPU kernel `paged_flash_decode_bkhd`
// (`_paged_decode_kernel`) of src/repro/kernels/paged/decode.py in its
// single-query form. Query rows g of a batch row b and KV head h attend to
// the pages `tables[b, t / ps]` (offset t % ps) of the k/v pools
// (KV, P, ps, hd) over positions t < L_b = min(lengths[b], n_pages * ps);
// q and out are (B, KV, G, hd), lengths (B,). The kernel is
// decode_step.cuh's `decode_step` with the paged loader (`PagedRows`); that
// header holds the design. It keeps paged_decode.cu's contract:
// - a row's L_b positions are divided among its splits by L_b alone, so
//   the split bounds never depend on a page id (prefix sharing on and off
//   stays bitwise equal);
// - no table entry and no position at or past L_b is read (entries there
//   may be out of range); positions past L_b in a tile are zero-filled by
//   `cp.async` with source size 0 and score -inf, so V there is never
//   loaded and a NaN page past every length cannot reach an output;
// - a length of 0 gives zeros (every split has l = 0; L is floored at
//   1e-30 in the combine);
// - copies are gathered per position, ((h P + tables[b, t / ps]) ps +
//   t % ps) hd, so any page size works; a thread reads the table entries
//   of four of its positions before it starts their copies, and one entry
//   serves K and V.
// fp32, G above 16 and the chunk form keep paged_decode.cu; this file is
// its own library so that that binary stays as it was.
//
// What bounds it: bytes, the live pages of every row read once (at most
// 4.7 MB at tinyllama's B 8, KV 4, 36 pages of 16, hd 64; ~2 flops a
// byte). It takes the place of paged_decode.cu's CUDA-core decode form
// (fp32 FMAs, 8 splits, a combine through a device-memory workspace by the
// last CTA to arrive), which ran 12-39x its bound at these shapes
// (PERF.md).
#include "decode_step.cuh"

namespace repro_torch {
namespace {

using step::bf16;

template <int HD, int POS>
__global__ void __launch_bounds__(step::kThreads)
paged_decode_step_kernel(const bf16* __restrict__ q, step::PagedRows rows,
                         bf16* __restrict__ out, int KV, int G, float scale,
                         float softcap) {
  step::decode_step<HD, POS>(q, rows, out, KV, G, scale, softcap);
}

template <int HD, int POS>
cudaError_t launch(const void* q, const step::PagedRows& rows, void* out,
                   int B, int KV, int G, int splits, float softcap,
                   cudaStream_t stream) {
  return step::launch<HD, POS>(paged_decode_step_kernel<HD, POS>, q, rows,
                               out, B, KV, G, splits, softcap, stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out (B, KV, G, hd) bf16; k, v (KV, P, ps, hd) bf16; tables (B,
// >= n_pages) int32 with row stride `tstride`; lengths (B,) int32.
// `splits` CTAs per (b, kv-head), 1 to 8, one cluster, each walking tiles
// of `tile` positions. `dtype` must be bf16, (hd, tile) one of (64, 64),
// (64, 128), (128, 64), (256, 64), and G at most 16.
extern "C" int paged_decode_step_launch(const void* q, const void* k,
                                        const void* v, const void* tables,
                                        const void* lengths, void* out,
                                        int B, int KV, int G, int P, int ps,
                                        int hd, int n_pages, int tstride,
                                        int splits, int tile, float softcap,
                                        int dtype, void* stream) {
  using namespace repro_torch;
  if (!step::takes(dtype, hd, tile, B, KV, G, splits) || P <= 0 ||
      ps <= 0 || n_pages < 0)
    return (int)cudaErrorInvalidValue;
  const step::PagedRows rows{static_cast<const step::bf16*>(k),
                             static_cast<const step::bf16*>(v),
                             static_cast<const int*>(tables),
                             static_cast<const int*>(lengths),
                             P, ps, n_pages, tstride};
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && tile == 128)
    return (int)launch<64, 128>(q, rows, out, B, KV, G, splits, softcap, s);
  if (hd == 64)
    return (int)launch<64, 64>(q, rows, out, B, KV, G, splits, softcap, s);
  if (hd == 128)
    return (int)launch<128, 64>(q, rows, out, B, KV, G, splits, softcap, s);
  return (int)launch<256, 64>(q, rows, out, B, KV, G, splits, softcap, s);
}

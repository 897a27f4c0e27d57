// The decode step of GQA attention over a dense KV cache, bf16 at hd 64,
// 128 and 256, on Hopper's tensor cores (sm_90a): tinyllama-1.1b's,
// granite-moe-3b-a800m's and whisper-tiny's decode step (hd 64),
// internvl2-26b's, yi-6b's and deepseek-67b's (hd 128), gemma-2b's (hd
// 256).
//
// Replaces, at these head dims, the TPU kernel `flash_decode_bkhd`
// (`_decode_kernel`) of src/repro/kernels/flash_decode.py. q (B,KV,G,hd)
// attends to k/v (B,KV,C,hd) with an additive fp32 bias (B,C). The kernel
// is decode_step.cuh's `decode_step` with the dense loader (`DenseRows`:
// C positions a row, position t at row (b KV + h) C + t, bias[b, t]); that
// header holds the design. fp32, G above 16 and the chunk forms keep their
// kernels (flash_decode.cu, flash_decode_chunk.cu); this file is its own
// library so that their binaries stay as they were.
//
// What bounds it: bytes. At gemma-2b's decode step (B 8, 8 query heads on
// one KV head, C 576) a call reads 4.7 MB of K and V for ~2 flops a byte:
// ~1.4 us at 3.35 TB/s; at tinyllama's (32 heads on 4 KV heads of hd 64)
// the same 4.7 MB; at internvl2-26b's (48 on 8 of hd 128: G 6) 18.9 MB,
// ~5.7 us.
//
// Measured at hd 128 and 256 (device ms, NVIDIA H100 80GB HBM3 at 700 W;
// chip_smoke --ab, parent and change in one call): internvl's step 0.0137
// (the CUDA-core kernel 0.0467, SDPA 0.0149, bound 0.0057), gemma's 0.0092
// (before the cluster 0.0124, SDPA 0.0131, bound 0.0014). By split count
// (--ab's sweep): internvl 2: 0.0174, 3: 0.0143, 4: 0.0150, 5: 0.0138, 6:
// 0.0137, 7: 0.0141, 8: 0.0147; gemma 2: 0.0174, 4: 0.0115, 6: 0.0098,
// 8: 0.0093. ptxas: 71 registers at hd 128, no spill (five CTAs an SM
// need at most 102); 96 at hd 256. Without its combine (kernel_variants.py,
// a wrong result on purpose) the kernel takes 0.0105 at internvl's 6
// splits and 0.0064 at gemma's 8: the cluster's two barriers and its
// reads of the peers' partials are the rest, ~0.003, and what holds the
// kernel at 2.4x (internvl) and 6.5x (gemma) its bound is one round of
// loads and products a CTA in a single wave, not the bytes.
// The combine before the cluster (the last CTA to arrive read every
// split's partial from L2, wg_arrive_and_combine in wgmma.cuh) cost
// 0.003-0.004 ms at either head dim and grew with the splits: at gemma 18
// splits 0.0125 (0.0065-0.0068 without the combine), at internvl 6 / 9
// splits 0.0150 / 0.0163 (0.0120 without); clusters above 8 CTAs
// (non-portable) ran slower (internvl 9: 0.0178). Tried and left out
// (--ab): the CUDA-core kernel (flash_decode.cu: fp32 FMAs, 8 splits, two
// 64-position tiles a split), gemma 0.0303, internvl 0.0469; the
// tensor-core chunk kernel called with ck = 1 (flash_decode_chunk.cu: G
// live rows of a 64-row `wgmma` block), gemma 0.0151 at its 4 splits and
// 0.0124-0.0128 at 9, internvl 0.0173 at 4. At hd 64 the step takes
// tiles of 64 or 128 positions (warps of 16 or 32 scored positions); the
// wrapper's STEP_SPLITS and STEP_TILE by head dim are the fastest of
// --ab's sweeps (PERF.md).
#include "decode_step.cuh"

namespace repro_torch {
namespace {

using step::bf16;

template <int HD, int POS>
__global__ void __launch_bounds__(step::kThreads)
flash_decode_step_kernel(const bf16* __restrict__ q, step::DenseRows rows,
                         bf16* __restrict__ out, int KV, int G, float scale,
                         float softcap) {
  step::decode_step<HD, POS>(q, rows, out, KV, G, scale, softcap);
}

template <int HD, int POS>
cudaError_t launch(const void* q, const step::DenseRows& rows, void* out,
                   int B, int KV, int G, int splits, float softcap,
                   cudaStream_t stream) {
  return step::launch<HD, POS>(flash_decode_step_kernel<HD, POS>, q, rows,
                               out, B, KV, G, splits, softcap, stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (ctypes). Returns the cudaError_t of the launch (0 = ok).
// q and out are (B, KV, G, hd) bf16, k and v (B, KV, C, hd) bf16, bias
// (B, C) fp32; `splits` CTAs per (b, kv-head), 1 to 8, one cluster, each
// walking tiles of `tile` positions. `dtype` must be bf16, (hd, tile) one
// of (64, 64), (64, 128), (128, 64), (256, 64), and G at most 16: what
// this kernel takes.
extern "C" int flash_decode_step_launch(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int B, int KV, int G,
                                        int C, int hd, int splits, int tile,
                                        float softcap, int dtype,
                                        void* stream) {
  using namespace repro_torch;
  if (!step::takes(dtype, hd, tile, B, KV, G, splits) || C <= 0)
    return (int)cudaErrorInvalidValue;
  const step::DenseRows rows{static_cast<const step::bf16*>(k),
                             static_cast<const step::bf16*>(v),
                             static_cast<const float*>(bias), C};
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && tile == 128)
    return (int)launch<64, 128>(q, rows, out, B, KV, G, splits, softcap, s);
  if (hd == 64)
    return (int)launch<64, 64>(q, rows, out, B, KV, G, splits, softcap, s);
  if (hd == 128)
    return (int)launch<128, 64>(q, rows, out, B, KV, G, splits, softcap, s);
  return (int)launch<256, 64>(q, rows, out, B, KV, G, splits, softcap, s);
}

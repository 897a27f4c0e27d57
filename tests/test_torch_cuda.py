"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips through the ``cuda`` fixture where there is none. This file imports
no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in different
orders); bf16 1e-2 (both round an fp32 result to bf16, at most one bf16
ulp apart for outputs of magnitude < 2). The SSD scan's outputs grow with
the sequence (|y| in the hundreds at s = 512), so it is held relative to
the plain version's largest magnitude: max |kernel - plain| / max |plain|
<= SSD_REL_TOL (fp32 1e-4: fp32 sums in other orders over 128-step
chunks; bf16 1e-2 for y, one bf16 rounding of the same fp32 value, 2^-8;
the fp32 final state 1e-4 in both).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models.ssd import ssd_scan_plain
from repro_torch.serving.graphs import capture_stream

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SSD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)
                           ).to(device=device, dtype=dtype)


DECODE_CASES = [
    # B, KV, G, hd, C, softcap, masked (True: -1e9 bias on slots C//2 ..;
    # "first": on every slot but the first)
    (8, 4, 8, 64, 576, 0.0, False),   # serve path: tinyllama at C = 512+64
    (2, 2, 4, 64, 100, 0.0, True),    # ragged C, -1e9 bias on some slots
    (3, 1, 8, 128, 64, 30.0, False),  # MQA, hd 128, softcap
    (1, 4, 1, 64, 7, 0.0, True),      # G 1, C below one tile
    (2, 2, 4, 64, 1, 0.0, False),     # C = 1: one split sees a position
    (3, 2, 8, 64, fd.SPLITS - 3, 0.0, True),  # C below the split count
    (2, 4, 8, 64, 576, 0.0, True),    # splits 4..7 wholly under the bias
    (4, 4, 8, 64, 203, 0.0, False),   # C not a multiple of the splits
    (8, 5, 5, 64, 576, 0.0, True),    # hymba-1.5b's group of 5 at C = 576
    (2, 2, 8, 128, 300, 30.0, True),  # hd 128 with softcap, ragged, biased
    (8, 1, 8, 256, 576, 0.0, False),  # gemma-2b's decode step: MQA, hd 256
    (2, 8, 1, 256, 96, 0.0, True),    # the reference test's hd 256, G 1
    (3, 1, 8, 256, 203, 30.0, True),  # hd 256: 64-position tiles, softcap
    (3, 2, 8, 256, fd.SPLITS - 3, 0.0, True),  # hd 256, C below the splits
    # the bf16 hd-256 decode step's tensor-core route (STEP_SPLITS CTAs per
    # (b, kv-head)): C 1, C just below and just above its split count, only
    # the first key unbiased, G 3 and G 7, a split of several 64-position
    # tiles
    (8, 1, 8, 256, 1, 0.0, False),
    (8, 1, 8, 256, fd.STEP_SPLITS - 1, 0.0, False),
    (8, 1, 8, 256, fd.STEP_SPLITS + 1, 30.0, True),
    (8, 1, 8, 256, 576, 0.0, "first"),
    (4, 2, 3, 256, 203, 0.0, True),
    (4, 1, 7, 256, 576, 30.0, False),
    (2, 1, 8, 256, 2000, 0.0, True),
    (8, 8, 3, 64, 576, 0.0, False),   # granite-moe's decode step: G 3
    (3, 8, 3, 64, 203, 30.0, True),   # G 3, ragged C, softcap, biased
    # whisper-tiny's decoder (6 heads on 6 KV heads of hd 64: G 1) at its
    # 64-token prompt + 64 steps, and internvl2-26b's decode step (48 heads
    # on 8 of hd 128: G 6, on the CUDA cores: STEP_HD is 256)
    (8, 6, 1, 64, 128, 0.0, False),
    (8, 8, 6, 128, 576, 0.0, False),
    (3, 8, 6, 128, 203, 30.0, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,C,softcap,masked", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(cuda, B, KV, G, hd, C, softcap,
                                           masked, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, KV, G, hd), dtype, cuda)
    k = _randn(rng, (B, KV, C, hd), dtype, cuda)
    v = _randn(rng, (B, KV, C, hd), dtype, cuda)
    bias = torch.zeros((B, C), device=cuda)
    if masked == "first":
        bias[:, 1:] = -1e9
    elif masked:
        bias[:, C // 2:] = -1e9
    n0 = fd.flash_decode_bkhd.launches
    out = fd.flash_decode_bkhd(q, k, v, bias, softcap=softcap)
    torch.cuda.synchronize()
    assert fd.flash_decode_bkhd.launches == n0 + 1
    want = fd.flash_decode_plain(q, k, v, bias, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


CHUNK_CASES = [
    # B, ck, KV, G, hd, C, softcap, bias: "causal" at ragged starts with
    # row 1 inert (n_valid 0: a query past it sees only key 0 onward) or
    # "first" (every key but the first under -1e9)
    (8, 16, 4, 8, 64, 576, 0.0, "causal"),    # the dense fused tick
    (8, 16, 4, 8, 64, 576, 30.0, "causal"),   # softcap
    (3, 5, 2, 8, 64, fd.SPLITS - 3, 0.0, "causal"),  # C below the splits
    (8, 16, 5, 5, 64, 576, 0.0, "causal"),    # hymba-1.5b's group of 5
    (2, 16, 2, 8, 128, 300, 0.0, "causal"),   # hd 128 (fp32: 32 rows a CTA)
    (2, 7, 2, 4, 128, 100, 30.0, "first"),
    (4, 16, 4, 8, 64, 576, 0.0, "first"),
    (2, 1, 2, 8, 64, 50, 0.0, "causal"),      # ck 1 in the chunk layout
    # the tensor-core route's edges (bf16, hd 64): C below its splits, C
    # not a multiple of its 64-position tiles, more tiles than splits with
    # a softcap, G 7 (a short second row block), G 1 (64 tokens a block)
    (3, 5, 2, 8, 64, fd.TC_SPLITS - 1, 0.0, "causal"),
    (4, 16, 4, 8, 64, 203, 0.0, "causal"),
    (2, 16, 2, 8, 64, 700, 30.0, "first"),
    (2, 9, 3, 7, 64, 130, 0.0, "causal"),
    (2, 80, 2, 1, 64, 320, 0.0, "causal"),
    # hd 256 (bf16 on the tensor cores, fp32 on the CUDA cores at 16 rows
    # a CTA): gemma-2b's dense fused tick (MQA), all but the first key
    # under the bias, G 1
    (8, 16, 1, 8, 256, 576, 0.0, "causal"),
    (8, 16, 1, 8, 256, 576, 30.0, "first"),
    (2, 5, 8, 1, 256, 100, 0.0, "causal"),
    # the tensor-core route's edges at hd 256 and 128 (yi-6b's fused tick
    # first): C below the splits, C not a multiple of the 64-position
    # tiles, more tiles than splits with a softcap, G 7 (a short second
    # row block), G 1 (64 tokens a block)
    (3, 5, 1, 8, 256, fd.TC_SPLITS - 1, 0.0, "causal"),
    (4, 16, 1, 8, 256, 203, 0.0, "causal"),
    (2, 16, 1, 8, 256, 700, 30.0, "first"),
    (2, 9, 3, 7, 256, 130, 0.0, "causal"),
    (2, 80, 2, 1, 256, 320, 0.0, "causal"),
    (8, 16, 4, 8, 128, 576, 0.0, "causal"),
    (3, 5, 2, 8, 128, fd.TC_SPLITS - 1, 0.0, "causal"),
    (4, 16, 4, 8, 128, 203, 0.0, "causal"),
    (2, 16, 2, 8, 128, 700, 30.0, "first"),
    (2, 9, 3, 7, 128, 130, 0.0, "causal"),
    (2, 80, 2, 1, 128, 320, 0.0, "causal"),
    # granite-moe's GQA group of 3 at hd 64: its dense fused tick (48 of a
    # block's 64 rows on the tensor-core route in bf16), a verify-sized
    # chunk with every key but the first under the bias
    (8, 16, 8, 3, 64, 576, 0.0, "causal"),
    (2, 5, 8, 3, 64, 100, 30.0, "first"),
    # internvl2-26b's dense fused tick and verify (G 6 at hd 128: 96 rows,
    # blocks of 64 straddling a token's group) and whisper's heads (G 1)
    (8, 16, 8, 6, 128, 576, 0.0, "causal"),
    (2, 5, 8, 6, 128, 100, 30.0, "first"),
    (8, 16, 6, 1, 64, 576, 0.0, "causal"),
]


def _chunk_bias(rng, B, ck, C, kind, device):
    if kind == "first":
        bias = torch.full((B, ck, C), -1e9)
        bias[..., 0] = 0.0
    else:
        start = torch.as_tensor(rng.integers(0, C, B))
        start[min(1, B - 1)] = 0
        pos = start[:, None] + torch.arange(ck)[None, :]
        bias = torch.where(torch.arange(C)[None, None, :] <= pos[:, :, None],
                           0.0, -1e9)
    return bias.float().to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,ck,KV,G,hd,C,softcap,kind", CHUNK_CASES)
def test_flash_decode_chunk_kernel_matches_plain(cuda, B, ck, KV, G, hd, C,
                                                 softcap, kind, dtype):
    """The chunk form, one launch, against its plain version (the stack of
    single-query plain calls), and its launch counted on its own key; bf16
    at hd 64, 128 and 256 plans the tensor-core route, fp32 the CUDA
    cores."""
    tc, rows, _ = fd.launch_plan(ck, G, hd, dtype, True)
    assert tc == (dtype == torch.bfloat16 and hd in (64, 128, 256))
    assert rows == (fd.TC_ROWS if tc else fd.chunk_rows(ck, G, hd))
    rng = np.random.default_rng(B * ck + C)
    q = _randn(rng, (B, ck, KV, G, hd), dtype, cuda)
    k = _randn(rng, (B, KV, C, hd), dtype, cuda)
    v = _randn(rng, (B, KV, C, hd), dtype, cuda)
    bias = _chunk_bias(rng, B, ck, C, kind, cuda)
    n0, d0 = fd.flash_decode_chunk.launches, fd.flash_decode_bkhd.launches
    out = fd.flash_decode_chunk(q, k, v, bias, softcap=softcap)
    torch.cuda.synchronize()
    assert fd.flash_decode_chunk.launches == n0 + 1
    assert fd.flash_decode_bkhd.launches == d0
    want = fd.flash_decode_chunk_plain(q, k, v, bias, softcap=softcap)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_chunk_equals_single_query_kernels(cuda, dtype):
    """Each chunk token's rows equal the decode kernel's at that token's
    bias row. fp32 runs the same arithmetic in the same order: bitwise.
    bf16 at hd 64 runs on the tensor cores, whose sums take another order
    by design: held to ``TOL``."""
    rng = np.random.default_rng(4)
    B, ck, KV, G, hd, C = 8, 16, 4, 8, 64, 576
    q = _randn(rng, (B, ck, KV, G, hd), dtype, cuda)
    k = _randn(rng, (B, KV, C, hd), dtype, cuda)
    v = _randn(rng, (B, KV, C, hd), dtype, cuda)
    bias = _chunk_bias(rng, B, ck, C, "causal", cuda)
    out = fd.flash_decode_chunk(q, k, v, bias)
    for j in range(ck):
        one = fd.flash_decode_bkhd(q[:, j].contiguous(), k, v,
                                   bias[:, j].contiguous())
        if dtype == torch.float32:
            assert torch.equal(out[:, j], one), j
        else:
            torch.testing.assert_close(out[:, j].float(), one.float(),
                                       atol=TOL[dtype], rtol=0)


def _device_kernels(fn, *args):
    """Names of the CUDA kernels the profiler sees ``fn(*args)`` launch (a
    trace that records no kernel at all is taken again)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "flash_decode_chunk_kernel"),
    (torch.float32, 64, "flash_decode_kernel"),
    (torch.bfloat16, 128, "flash_decode_chunk_kernel"),
    (torch.bfloat16, 256, "flash_decode_chunk_kernel"),
    (torch.float32, 256, "flash_decode_kernel"),
])
def test_flash_decode_chunk_runs_the_planned_kernel(cuda, dtype, hd, kernel):
    """The profiler sees the chunk form launch the kernel its plan names:
    the tensor-core kernel in bf16 (hd 64, 128, 256), the CUDA-core one
    in fp32 (a trace that records no kernel at all is taken again)."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, 16, 2, 8, hd), dtype, cuda)
    k = _randn(rng, (2, 2, 300, hd), dtype, cuda)
    bias = _chunk_bias(rng, 2, 16, 300, "causal", cuda)
    names = _device_kernels(fd.flash_decode_chunk, q, k, k, bias)
    ran = [n for n in names if "flash_decode" in n]
    assert len(ran) == 1 and kernel in ran[0], names


def test_flash_decode_workspace_is_left_clean(cuda):
    """The last split of each block sets its arrival counter back to zero,
    so the reused workspace serves the next call: decode calls of other
    shapes and a repeat, interleaved with tensor-core chunk launches
    (bf16, hd 64) and paged launches on the same workspace, give the plain
    versions' answers and leave every counter at zero."""
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    tol = dict(atol=TOL[bf], rtol=TOL[bf])
    for B, KV, G, C in ((8, 4, 8, 576), (2, 5, 5, 100), (8, 4, 8, 576)):
        q = _randn(rng, (B, KV, G, 64), bf, cuda)
        k = _randn(rng, (B, KV, C, 64), bf, cuda)
        v = _randn(rng, (B, KV, C, 64), bf, cuda)
        bias = torch.zeros((B, C), device=cuda)
        out = fd.flash_decode_bkhd(q, k, v, bias)
        torch.testing.assert_close(out.float(),
                                   fd.flash_decode_plain(q, k, v, bias).float(),
                                   **tol)
        ck = 16 if C > 100 else 3
        qc = _randn(rng, (B, ck, KV, G, 64), bf, cuda)
        bc = _chunk_bias(rng, B, ck, C, "causal", cuda)
        torch.testing.assert_close(
            fd.flash_decode_chunk(qc, k, v, bc).float(),
            fd.flash_decode_chunk_plain(qc, k, v, bc).float(), **tol)
        pq, kp, vp, tables, lengths = _paged_inputs(rng, B, KV, G, 64, 16,
                                                    4, bf, cuda)
        torch.testing.assert_close(
            pd.paged_flash_decode_bkhd(pq, kp, vp, tables, lengths).float(),
            pd.paged_flash_decode_plain(pq, kp, vp, tables, lengths).float(),
            **tol)
    torch.cuda.synchronize()
    assert int(_arrivals(cuda).abs().sum()) == 0


def _arrivals(device):
    """The arrival counters of the split kernels' workspace on the current
    stream (shared by flash_decode and paged_decode)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    return build._WORKSPACE[(torch.cuda.current_device(), stream)][1]


PREFILL_CASES = [
    # B, S, H, KV, hd, window, softcap
    (8, 512, 32, 4, 64, 0, 0.0),      # serve path: tinyllama, 512 prompt
    (2, 40, 4, 1, 64, 0, 0.0),        # ragged S (not a tile multiple)
    (1, 130, 8, 2, 64, 8, 30.0),      # sliding window + softcap
    (2, 96, 4, 4, 128, 0, 0.0),       # hd 128, G 1
    (2, 1, 4, 2, 64, 0, 0.0),         # S = 1
    (2, 15, 8, 2, 64, 0, 0.0),        # S around a warp's 16 query rows
    (2, 16, 8, 2, 64, 0, 0.0),
    (2, 17, 8, 2, 64, 0, 0.0),
    (2, 127, 4, 2, 64, 0, 0.0),       # S around two 64-row tiles
    (2, 129, 4, 2, 64, 0, 0.0),
    (1, 200, 8, 2, 64, 64, 0.0),      # window of exactly one tile
    (1, 300, 8, 2, 64, 100, 0.0),     # window crossing a tile edge
    (2, 200, 8, 2, 128, 48, 30.0),    # hd 128 with G 4, window, softcap
    (8, 512, 25, 5, 64, 256, 0.0),    # hymba-1.5b's heads, window 256
    (8, 512, 8, 1, 256, 0, 0.0),      # gemma-2b's serve shape: MQA, hd 256
    (1, 96, 8, 8, 256, 0, 0.0),       # the reference test's hd-256 shape
    (2, 200, 8, 1, 256, 48, 30.0),    # hd 256, window, softcap
    (2, 17, 8, 1, 256, 0, 0.0),       # hd 256, S past one warp's rows
    # the bf16 hd-256 route (two heads of a KV head a CTA): S 1, around one
    # and two 64-row tiles, B 1 with a softcap, G 3 and G 7 (an unpaired
    # head; G 3 on two KV heads with a window)
    (2, 1, 8, 1, 256, 0, 0.0),
    (2, 63, 8, 1, 256, 0, 0.0),
    (2, 65, 8, 1, 256, 0, 0.0),
    (1, 129, 8, 1, 256, 0, 30.0),
    (2, 130, 6, 2, 256, 48, 0.0),
    (1, 200, 7, 1, 256, 0, 0.0),
    (2, 128, 4, 4, 32, 32, 0.0),      # the reference test's hd 32, window
    (2, 130, 4, 2, 32, 8, 30.0),      # hd 32, ragged S, window, softcap
    (8, 512, 24, 8, 64, 0, 0.0),      # granite-moe's prefill: G 3
    (2, 130, 24, 8, 64, 48, 30.0),    # G 3, ragged S, window, softcap
    (8, 64, 6, 6, 64, 0, 0.0),        # whisper-tiny's decoder prompt: G 1
    (2, 768, 48, 8, 128, 0, 0.0),     # internvl2-26b: 256 image + 512 text
    (2, 130, 48, 8, 128, 48, 30.0),   # G 6, ragged S, window, softcap
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window,softcap", PREFILL_CASES)
def test_flash_prefill_kernel_matches_plain(cuda, B, S, H, KV, hd, window,
                                            softcap, dtype):
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, S, H, hd), dtype, cuda)
    k = _randn(rng, (B, S, KV, hd), dtype, cuda)
    v = _randn(rng, (B, S, KV, hd), dtype, cuda)
    n0 = fp.flash_prefill_bshd.launches
    out = fp.flash_prefill_bshd(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fp.flash_prefill_bshd.launches == n0 + 1
    want = fp.flash_prefill_plain(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 256, "flash_prefill_wide_kernel"),
    (torch.float32, 256, "flash_prefill_simt_kernel"),
    (torch.bfloat16, 64, "flash_prefill_wgmma_kernel"),
    (torch.bfloat16, 128, "flash_prefill_mma_kernel"),
])
def test_flash_prefill_runs_the_planned_kernel(cuda, dtype, hd, kernel):
    """The profiler sees flash_prefill launch the kernel ``launch_plan``
    names: at gemma-2b's hd 256 the two-head ``wgmma`` kernel in bf16 and
    the CUDA-core one in fp32."""
    assert fp.launch_plan(hd, dtype)[0] == kernel
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 130, 8, hd), dtype, cuda)
    k = _randn(rng, (2, 130, 1, hd), dtype, cuda)
    names = _device_kernels(fp.flash_prefill_bshd, q, k, k)
    ran = [n for n in names if "flash_prefill" in n]
    assert len(ran) == 1 and kernel in ran[0], names


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 256, "flash_decode_step_kernel"),
    (torch.float32, 256, "flash_decode_kernel"),
    (torch.bfloat16, 64, "flash_decode_kernel"),
])
def test_flash_decode_step_runs_the_planned_kernel(cuda, dtype, hd, kernel):
    """The profiler sees the decode step launch the kernel its plan names:
    at gemma-2b's hd 256 the tensor-core step kernel in bf16 (over
    ``STEP_SPLITS`` CTAs a (b, kv-head)) and the CUDA-core one in fp32; at
    hd 64 the CUDA-core one in both."""
    tc, _, _ = fd.launch_plan(1, 8, hd, dtype, False)
    assert fd.KERNELS[tc, False][1] == kernel
    rng = np.random.default_rng(8)
    q = _randn(rng, (8, 1, 8, hd), dtype, cuda)
    k = _randn(rng, (8, 1, 576, hd), dtype, cuda)
    names = _device_kernels(fd.flash_decode_bkhd, q, k, k,
                            torch.zeros((8, 576), device=cuda))
    ran = [n for n in names if "flash_decode" in n]
    assert len(ran) == 1 and kernel in ran[0], names


def _new_head_inputs(route, H, KV, hd, dtype, device):
    """One call's operands of ``route`` at a config's heads (B 8, prompt
    64, ring 576, 36 pages of 16, chunks of 16)."""
    rng = np.random.default_rng(11)
    G = H // KV
    if route == "prefill":
        return (fp.flash_prefill_bshd, fp.flash_prefill_plain,
                (_randn(rng, (8, 64, H, hd), dtype, device),
                 _randn(rng, (8, 64, KV, hd), dtype, device),
                 _randn(rng, (8, 64, KV, hd), dtype, device)))
    if route in ("decode", "chunk"):
        k = _randn(rng, (8, KV, 576, hd), dtype, device)
        v = _randn(rng, (8, KV, 576, hd), dtype, device)
        if route == "decode":
            return (fd.flash_decode_bkhd, fd.flash_decode_plain,
                    (_randn(rng, (8, KV, G, hd), dtype, device), k, v,
                     torch.zeros((8, 576), device=device)))
        return (fd.flash_decode_chunk, fd.flash_decode_chunk_plain,
                (_randn(rng, (8, 16, KV, G, hd), dtype, device), k, v,
                 _chunk_bias(rng, 8, 16, 576, "causal", device)))
    if route == "paged":
        return (pd.paged_flash_decode_bkhd, pd.paged_flash_decode_plain,
                _paged_inputs(rng, 8, KV, G, hd, 16, 36, dtype, device))
    return (pd.paged_flash_decode_chunk, pd.paged_flash_decode_chunk_plain,
            _chunk_inputs(rng, 8, KV, G, hd, 16, 36, 36, 16, dtype, device))


def _planned(route, G, hd, dtype):
    """The kernel name each route's plan picks."""
    if route == "prefill":
        return fp.launch_plan(hd, dtype)[0]
    if route in ("decode", "chunk"):
        chunk = route == "chunk"
        return fd.KERNELS[fd.launch_plan(16 if chunk else 1, G, hd, dtype,
                                         chunk)[0], chunk][1]
    tc = pd.launch_plan(16, G, hd, dtype, route == "paged_chunk")[0]
    return "paged_chunk_wgmma_kernel" if tc else "paged_decode_simt_kernel"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["prefill", "decode", "chunk", "paged",
                                   "paged_chunk"])
@pytest.mark.parametrize("H,KV,hd", [(6, 6, 64), (48, 8, 128)],
                         ids=["whisper-G1-64", "internvl-G6-128"])
def test_new_head_shapes_run_the_planned_kernel(cuda, H, KV, hd, route,
                                                dtype):
    """Every route at whisper-tiny's heads (G 1, hd 64) and internvl2-26b's
    (G 6, hd 128) launches the kernel its plan names, as the profiler sees
    it, and agrees with its plain version."""
    fn, plain, args = _new_head_inputs(route, H, KV, hd, dtype, cuda)
    torch.testing.assert_close(fn(*args).float(), plain(*args).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    names = _device_kernels(fn, *args)
    ran = [n for n in names if "flash_" in n or "paged_" in n]
    want = _planned(route, H // KV, hd, dtype)
    assert len(ran) == 1 and want in ran[0], (names, want)


def test_flash_decode_step_is_deterministic(cuda):
    """The step kernel's last CTA combines the splits in split order: two
    calls on the same inputs are bitwise equal, and the arrival counters
    are back at zero."""
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    q = _randn(rng, (8, 1, 8, 256), bf, cuda)
    k = _randn(rng, (8, 1, 576, 256), bf, cuda)
    v = _randn(rng, (8, 1, 576, 256), bf, cuda)
    bias = torch.zeros((8, 576), device=cuda)
    bias[:, 400:] = -1e9
    first = fd.flash_decode_bkhd(q, k, v, bias)
    for _ in range(3):
        assert torch.equal(fd.flash_decode_bkhd(q, k, v, bias), first)
    torch.cuda.synchronize()
    assert int(_arrivals(cuda).abs().sum()) == 0


def _paged_inputs(rng, B, KV, G, hd, ps, width, dtype, device,
                  poison=False):
    """A pool of B*width+1 pages shuffled across the rows' tables, ragged
    lengths in 1..width*ps with the last row at 0. With ``poison``, page 0
    holds NaN and every table entry past a row's live pages points at it."""
    P = B * width + 1
    q = _randn(rng, (B, KV, G, hd), dtype, device)
    kp = _randn(rng, (KV, P, ps, hd), dtype, device)
    vp = _randn(rng, (KV, P, ps, hd), dtype, device)
    tables = rng.permutation(np.arange(1, P)).reshape(B, width)
    lengths = rng.integers(1, width * ps + 1, B)
    lengths[-1] = 0
    if poison:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
        for b in range(B):
            tables[b, -(-int(lengths[b]) // ps):] = 0
    return (q, kp, vp,
            torch.as_tensor(tables, dtype=torch.int32, device=device),
            torch.as_tensor(lengths, dtype=torch.int32, device=device))


PAGED_CASES = [
    # B, KV, G, hd, ps, width, n_pages, softcap, poison
    (8, 4, 8, 64, 16, 36, 36, 0.0, False),   # serve path: 36 pages of 16
    (3, 2, 4, 128, 8, 10, 10, 0.0, False),   # page 8, hd 128
    (4, 4, 8, 64, 16, 12, 12, 30.0, False),  # softcap
    (5, 2, 4, 64, 16, 12, 5, 0.0, False),    # n_pages < table width
    (6, 4, 8, 64, 16, 9, 9, 0.0, True),      # NaN pages past each length
    (8, 1, 8, 256, 16, 36, 36, 0.0, False),  # gemma-2b's decode: hd 256
    (6, 1, 8, 256, 16, 9, 9, 30.0, True),    # hd 256, softcap, NaN pages
    (3, 8, 1, 256, 16, 12, 12, 0.0, True),   # hd 256, G 1
    (8, 8, 3, 64, 16, 36, 36, 0.0, False),   # granite-moe's decode: G 3
    (4, 8, 3, 64, 16, 12, 12, 30.0, True),   # G 3, softcap, NaN pages
    (8, 8, 6, 128, 16, 36, 36, 0.0, False),  # internvl2-26b's decode: G 6
    (4, 8, 6, 128, 16, 12, 12, 30.0, True),  # G 6, softcap, NaN pages
    (8, 6, 1, 64, 16, 36, 36, 0.0, True),    # whisper's heads: G 1
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,ps,width,n_pages,softcap,poison",
                         PAGED_CASES)
def test_paged_decode_kernel_matches_plain(cuda, B, KV, G, hd, ps, width,
                                           n_pages, softcap, poison, dtype):
    rng = np.random.default_rng(3)
    q, kp, vp, tables, lengths = _paged_inputs(rng, B, KV, G, hd, ps, width,
                                               dtype, cuda, poison)
    tables = tables[:, :n_pages]            # a column slice, not a copy
    n0 = pd.paged_flash_decode_bkhd.launches
    out = pd.paged_flash_decode_bkhd(q, kp, vp, tables, lengths,
                                     softcap=softcap)
    torch.cuda.synchronize()
    assert pd.paged_flash_decode_bkhd.launches == n0 + 1
    want = pd.paged_flash_decode_plain(q, kp, vp, tables, lengths,
                                       softcap=softcap)
    assert torch.isfinite(out.float()).all()
    assert (out[-1] == 0).all()             # the length-0 row gives zeros
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


PAGED_EDGES = [
    # B, KV, G, hd, ps, width, lengths (NaN pages past each length)
    (4, 2, 8, 64, 16, 36, (0, 3, 203, 576)),  # 0; below the split count;
    #                                           not a multiple of it; full
    (3, 2, 4, 64, 16, 1, (1, 16, 7)),         # a one-page table
    (2, 1, 8, 128, 8, 1, (8, 5)),             # one page of 8, hd 128
    (3, 4, 8, 64, 16, 36, (9, 1, 65)),        # lengths shorter than a split
    (4, 1, 8, 256, 16, 36, (0, 3, 203, 576)),  # the same at gemma's hd 256
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,ps,width,lens", PAGED_EDGES)
def test_paged_decode_split_edges(cuda, B, KV, G, hd, ps, width, lens,
                                  dtype):
    """The decode form's split over positions: empty splits (a length of 0,
    or below the split count), a length not a multiple of the splits, a
    one-page table; poisoned pages past every length."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, _ = _paged_inputs(rng, B, KV, G, hd, ps, width, dtype,
                                         cuda)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    for b, n in enumerate(lens):
        tables[b, -(-n // ps):] = 0
    out = pd.paged_flash_decode_bkhd(q, kp, vp, tables, lengths)
    want = pd.paged_flash_decode_plain(q, kp, vp, tables, lengths)
    assert torch.isfinite(out.float()).all()
    for b, n in enumerate(lens):
        if n == 0:
            assert (out[b] == 0).all()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _chunk_inputs(rng, B, KV, G, hd, ps, width, n_pages, ck, dtype, device,
                  poison=False):
    """Chunk-form operands: q (B, ck, KV, G, hd), a shuffled pool, tables
    sliced to n_pages columns of width, and lengths clip(start + j + 1, 1,
    T) with row 0 crossing the 64-position tile border, row 1 all 1, row 2
    clipped at T and row 3 zero at every other token. With ``poison``,
    page 0 holds NaN and every table entry past a row's largest length
    points at it."""
    P = B * width + 1
    T = n_pages * ps
    q = _randn(rng, (B, ck, KV, G, hd), dtype, device)
    kp = _randn(rng, (KV, P, ps, hd), dtype, device)
    vp = _randn(rng, (KV, P, ps, hd), dtype, device)
    tables = rng.permutation(np.arange(1, P)).reshape(B, width)
    start = rng.integers(0, T, B)
    start[0] = min(64 - ck // 2, T - 1)
    if B > 2:
        start[2] = T - 2
    lengths = np.clip(start[:, None] + np.arange(ck)[None, :] + 1, 1, T)
    lengths[1] = 1
    if B > 3:
        lengths[3, ::2] = 0
    if poison:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
        for b in range(B):
            tables[b, -(-int(lengths[b].max()) // ps):] = 0
    tables = torch.as_tensor(tables, dtype=torch.int32, device=device)
    return (q, kp, vp, tables[:, :n_pages],
            torch.as_tensor(lengths, dtype=torch.int32, device=device))


CHUNK_CASES = [
    # B, KV, G, hd, ps, width, n_pages, ck, softcap, poison
    (8, 4, 8, 64, 16, 36, 36, 16, 0.0, False),  # the fused tick's shape
    (8, 4, 8, 64, 16, 36, 36, 16, 0.0, True),   # NaN pages past each row
    (3, 2, 4, 128, 8, 10, 10, 5, 0.0, False),   # hd 128, page 8
    (4, 4, 8, 64, 16, 12, 12, 16, 30.0, True),  # softcap
    (5, 2, 1, 64, 8, 20, 12, 5, 0.0, True),     # G 1, a narrower slice
    (4, 1, 8, 64, 16, 9, 9, 1, 0.0, False),     # ck 1
    (4, 2, 5, 64, 16, 12, 12, 16, 0.0, True),   # G 5: 80 rows, 2 blocks
    (8, 1, 8, 256, 16, 36, 36, 16, 0.0, True),  # gemma-2b's fused tick
    (4, 1, 8, 256, 16, 12, 12, 16, 30.0, False),  # hd 256 with softcap
    (3, 4, 1, 256, 8, 10, 10, 5, 0.0, True),    # hd 256, G 1, page 8
    # the tensor-core route's edges at hd 256 and 128 (yi-6b's fused tick
    # first): 32 positions, fewer tiles than splits; 208, not a multiple
    # of the 64-position tiles; 11 tiles over the splits with a softcap;
    # G 7 (a short second row block); G 1 (64 tokens a block); page 8
    (3, 1, 8, 256, 16, 2, 2, 5, 0.0, True),
    (4, 1, 8, 256, 16, 13, 13, 16, 0.0, True),
    (2, 1, 8, 256, 16, 44, 44, 16, 30.0, False),
    (2, 3, 7, 256, 16, 9, 9, 10, 0.0, True),
    (2, 2, 1, 256, 16, 12, 12, 80, 0.0, True),
    (4, 1, 8, 256, 8, 72, 72, 16, 30.0, True),
    (8, 4, 8, 128, 16, 36, 36, 16, 0.0, True),
    (3, 2, 8, 128, 16, 2, 2, 5, 0.0, True),
    (4, 4, 8, 128, 16, 13, 13, 16, 0.0, True),
    (2, 2, 8, 128, 16, 44, 44, 16, 30.0, False),
    (2, 3, 7, 128, 16, 9, 9, 10, 0.0, True),
    (2, 2, 1, 128, 16, 12, 12, 80, 0.0, True),
    (4, 2, 8, 128, 8, 72, 72, 16, 30.0, True),
    (8, 8, 3, 64, 16, 36, 36, 16, 0.0, True),   # granite-moe's fused tick
    (3, 8, 3, 64, 16, 10, 10, 5, 30.0, False),  # G 3 at the verify's ck 5
    (8, 8, 6, 128, 16, 36, 36, 16, 0.0, True),  # internvl2-26b's fused tick
    (3, 8, 6, 128, 16, 10, 10, 5, 30.0, False),  # G 6 at the verify's ck 5
    (8, 6, 1, 64, 16, 36, 36, 16, 0.0, True),   # whisper's heads: G 1
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,ps,width,n_pages,ck,softcap,poison",
                         CHUNK_CASES)
def test_paged_chunk_kernel_matches_plain(cuda, B, KV, G, hd, ps, width,
                                          n_pages, ck, softcap, poison,
                                          dtype):
    """The chunk form, one launch, against its plain version: bf16 at hd 64,
    128 and 256 plans the tensor-core route, fp32 the CUDA cores."""
    tc = pd.launch_plan(ck, G, hd, dtype, True)[0]
    assert tc == (dtype == torch.bfloat16 and hd in (64, 128, 256))
    rng = np.random.default_rng(11)
    q, kp, vp, tables, lengths = _chunk_inputs(
        rng, B, KV, G, hd, ps, width, n_pages, ck, dtype, cuda, poison)
    n0 = pd.paged_flash_decode_bkhd.launches
    out = pd.paged_flash_decode_chunk(q, kp, vp, tables, lengths,
                                      softcap=softcap)
    torch.cuda.synchronize()
    assert pd.paged_flash_decode_bkhd.launches == n0 + 1
    want = pd.paged_flash_decode_chunk_plain(q, kp, vp, tables, lengths,
                                             softcap=softcap)
    assert torch.isfinite(out.float()).all()
    assert (out.float()[lengths == 0] == 0).all()   # a length of 0: zeros
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_chunk_kernel_equals_single_query_kernels(cuda, dtype):
    """One chunk launch against ck launches of the single-query kernel at
    each token's lengths (the reference's per-token loop), at the fused
    tick's shape."""
    q, kp, vp, tables, lengths = _chunk_inputs(
        np.random.default_rng(12), 8, 4, 8, 64, 16, 36, 36, 16, dtype, cuda)
    out = pd.paged_flash_decode_chunk(q, kp, vp, tables, lengths)
    per_token = torch.stack([
        pd.paged_flash_decode_bkhd(q[:, j].contiguous(), kp, vp, tables,
                                   lengths[:, j].contiguous())
        for j in range(q.shape[1])], dim=1)
    torch.testing.assert_close(out.float(), per_token.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_paged_decode_workspace_is_left_clean(cuda):
    """The last split of each block sets its arrival counter back to zero:
    chunk and decode launches of other shapes, interleaved with
    flash_decode on the same workspace, give the plain versions' answers
    and leave every counter at zero."""
    rng = np.random.default_rng(13)
    for shape in ((8, 4, 8, 64, 16, 36, 36, 16), (3, 2, 4, 128, 8, 10, 10, 5),
                  (8, 4, 8, 64, 16, 36, 36, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tables, lengths = _chunk_inputs(rng, *shape, dtype,
                                                       cuda)
            torch.testing.assert_close(
                pd.paged_flash_decode_chunk(q, kp, vp, tables, lengths)
                .float(),
                pd.paged_flash_decode_chunk_plain(q, kp, vp, tables, lengths)
                .float(), atol=TOL[dtype], rtol=TOL[dtype])
            qd, ld = q[:, 0].contiguous(), lengths[:, -1].contiguous()
            torch.testing.assert_close(
                pd.paged_flash_decode_bkhd(qd, kp, vp, tables, ld).float(),
                pd.paged_flash_decode_plain(qd, kp, vp, tables, ld).float(),
                atol=TOL[dtype], rtol=TOL[dtype])
        qf = _randn(rng, (8, 4, 8, 64), torch.bfloat16, cuda)
        kf = _randn(rng, (8, 4, 576, 64), torch.bfloat16, cuda)
        fd.flash_decode_bkhd(qf, kf, kf, torch.zeros((8, 576), device=cuda))
    torch.cuda.synchronize()
    assert int(_arrivals(cuda).abs().sum()) == 0


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    kv = torch.zeros((1, 8, 1, 64), device=cuda)
    with pytest.raises(ValueError):              # non-contiguous operand
        ops.flash_prefill(q.transpose(1, 2).contiguous().transpose(1, 2),
                          kv, kv)
    with pytest.raises(ValueError):              # head_dim not built
        ops.flash_prefill(torch.zeros((1, 8, 2, 48), device=cuda),
                          torch.zeros((1, 8, 1, 48), device=cuda),
                          torch.zeros((1, 8, 1, 48), device=cuda))
    with pytest.raises(TypeError):               # bias must be fp32
        ops.flash_decode_bkchd(torch.zeros((1, 1, 2, 64), device=cuda),
                               torch.zeros((1, 1, 8, 64), device=cuda),
                               torch.zeros((1, 1, 8, 64), device=cuda),
                               torch.zeros((1, 8), device=cuda,
                                           dtype=torch.bfloat16))
    q = torch.zeros((2, 2, 4, 64), device=cuda)
    pool = torch.zeros((2, 5, 16, 64), device=cuda)
    tables = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    n0 = pd.paged_flash_decode_bkhd.launches
    with pytest.raises(ValueError):              # int64 block table
        pd.paged_flash_decode_bkhd(q, pool, pool, tables.long(), lengths)
    with pytest.raises(TypeError):               # int64 lengths
        pd.paged_flash_decode_bkhd(q, pool, pool, tables, lengths.long())
    with pytest.raises(ValueError):              # non-contiguous pool
        ops.paged_flash_decode(q, pool.transpose(2, 3).contiguous()
                               .transpose(2, 3), pool, tables, lengths)
    with pytest.raises(ValueError):              # pool on the CPU
        ops.paged_flash_decode(q, pool.cpu(), pool, tables, lengths)
    qc = torch.zeros((2, 3, 2, 4, 64), device=cuda)
    lc = torch.ones((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):              # lengths not (B, ck)
        pd.paged_flash_decode_chunk(qc, pool, pool, tables, lengths)
    with pytest.raises(TypeError):               # int64 lengths
        pd.paged_flash_decode_chunk(qc, pool, pool, tables, lc.long())
    with pytest.raises(ValueError):              # non-contiguous q
        pd.paged_flash_decode_chunk(qc.transpose(1, 2).contiguous()
                                    .transpose(1, 2), pool, pool, tables, lc)
    with pytest.raises(TypeError):               # pool in another dtype
        ops.paged_flash_decode_chunk(qc, pool.to(torch.bfloat16),
                                     pool.to(torch.bfloat16), tables, lc)
    with pytest.raises(ValueError):              # hd not a multiple of 8
        ops.paged_flash_decode_chunk(qc[..., :60], pool[..., :60],
                                     pool[..., :60], tables, lc)
    assert pd.paged_flash_decode_bkhd.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_512_is_refused_before_any_launch(cuda, dtype):
    """hd 256 is the widest head the kernels take: at hd 512 each wrapper
    raises (prefill: no instance; the decode kernels: a ring past one
    block's shared memory) and launches nothing."""
    def z(*shape):
        return torch.zeros(shape, device=cuda, dtype=dtype)
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="hd"):
        fp.flash_prefill_bshd(z(1, 8, 8, 512), z(1, 8, 1, 512),
                              z(1, 8, 1, 512))
    bias = torch.zeros((1, 8), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fd.flash_decode_bkhd(z(1, 1, 8, 512), z(1, 1, 8, 512),
                             z(1, 1, 8, 512), bias)
    with pytest.raises(ValueError, match="shared memory"):
        fd.flash_decode_chunk(z(1, 2, 1, 8, 512), z(1, 1, 8, 512),
                              z(1, 1, 8, 512), bias[:, None].expand(1, 2, 8)
                              .contiguous())
    tables = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pd.paged_flash_decode_bkhd(z(1, 1, 8, 512), z(1, 2, 16, 512),
                                   z(1, 2, 16, 512), tables, lengths)
    assert ops.launch_counts() == counts


def test_model_greedy_tokens_kernels_on_equal_off(cuda):
    """fp32 smoke rung: identical greedy continuation with the kernels on
    (CUDA) and off (plain PyTorch) on the card."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import LM
    cfg = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=128, num_layers=2)
    outs = []
    for on in (False, True):
        lm = LM(cfg.replace(use_kernels=on))
        params = lm.init(torch.Generator(device=cuda).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 40)), device=cuda)
        logits, cache = lm.prefill(params, {"tokens": toks}, max_len=48)
        seq = []
        for _ in range(8):
            tok = torch.argmax(logits, dim=-1)
            seq.append(tok)
            logits, cache = lm.decode_step(params, cache, tok)
        outs.append(torch.stack(seq, 1).cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("arch,over", [
    ("gemma-2b", dict(num_heads=8, head_dim=256)),    # MQA G 8, hd 256
    ("yi-6b", dict(num_heads=8, num_kv_heads=2, head_dim=128)),
    ("deepseek-67b", {})])
def test_dense_configs_greedy_tokens_kernels_on_equal_off(cuda, arch, over):
    """fp32 2-layer rungs of the other dense configs (gemma-2b at its
    published head shape: GeGLU, tied embedding, the embedding scale):
    identical greedy continuation with the kernels on and off, and a
    flash_prefill launch per layer per prefill, a flash_decode launch per
    layer per step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import LM
    cfg = smoke_variant(get_config(arch)).replace(d_model=128, num_layers=2,
                                                  **over)
    outs = []
    for on in (False, True):
        lm = LM(cfg.replace(use_kernels=on))
        params = lm.init(torch.Generator(device=cuda).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 40)), device=cuda)
        n0 = ops.launch_counts()
        logits, cache = lm.prefill(params, {"tokens": toks}, max_len=48)
        seq = []
        for _ in range(8):
            tok = torch.argmax(logits, dim=-1)
            seq.append(tok)
            logits, cache = lm.decode_step(params, cache, tok)
        n1 = ops.launch_counts()
        assert n1["flash_prefill"] - n0["flash_prefill"] == 2 * on
        assert n1["flash_decode"] - n0["flash_decode"] == 16 * on
        outs.append(torch.stack(seq, 1).cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_paged_engine_greedy_tokens_kernels_on_equal_off(cuda):
    """fp32 smoke rung on the paged engine with prefix sharing: identical
    per-request tokens with the kernels on (paged decode in decode steps
    and its chunk form, once per layer, in fused ticks) and off."""
    import time
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=128, num_layers=2, name="small")
    rng = np.random.default_rng(9)
    pre = rng.integers(0, cfg.vocab_size, 24)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, 8)])
               for _ in range(3)]
    prompts += [prompts[0], prompts[1]]          # exact repeats: CoW path
    outs, hits = [], []
    for on in (False, True):
        eng = InProcessServingEngine(
            {"small": (cfg, 70.0)}, max_batch=3, prompt_len=32, max_new=8,
            decode_chunk=2, kv_cache="paged", kv_page_size=8,
            kv_prefix_sharing=True, prefill_chunk=8, use_kernels=on,
            device=cuda)
        eng.apply_allocation(0.0, {"small": 1})
        n0 = pd.paged_flash_decode_bkhd.launches
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new=8,
                               arrival=time.time()), "small")
            eng.step(0.0)
        eng.drain(0.0)
        assert (pd.paged_flash_decode_bkhd.launches > n0) == on
        outs.append({r.rid: list(r.output) for r in eng.done})
        hits.append(eng.kv_pool_stats()["prefix_hits"])
        eng.backends["small"].pool.assert_invariants()
    assert len(outs[0]) == len(prompts) and hits[0] > 0
    assert outs[0] == outs[1]


SSD_CASES = [
    # b, s, h, p, n, chunk
    (8, 512, 24, 64, 128, 128),   # serve path: mamba2-130m, 512 prompt
    (8, 512, 50, 64, 16, 128),    # hymba-1.5b heads
    (8, 16, 8, 32, 16, 16),       # smoke ladder (d_model 128), prompt 16
    (2, 300, 4, 64, 128, 128),    # ragged last chunk (44 of 128)
    (3, 45, 8, 32, 16, 16),       # ragged, chunk below one row tile
    (1, 5, 2, 64, 32, 5),         # s below the conv width scale, n 32
    (2, 2048, 24, 64, 128, 128),  # sixteen chunks through the state pass
    (4, 512, 24, 64, 128, 64),    # chunk 64
    (2, 129, 8, 64, 128, 128),    # a one-step last chunk
]


def _ssd_inputs(rng, b, s, h, p, n, dtype, device, strided=False):
    """x, dt, A, B, C, initial state; with ``strided`` x/B/C are views of
    one packed (b, s, h*p + 2n) tensor, as ``ssm_forward`` passes them."""
    f = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32)).to(device)
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -f(h).abs()
    init = f(b, h, p, n) * 0.1
    if strided:
        xc = f(b, s, h * p + 2 * n).to(dtype)
        x = xc[..., :h * p].unflatten(-1, (h, p))
        B, C = xc[..., h * p:h * p + n], xc[..., h * p + n:]
    else:
        x, B, C = (f(b, s, h, p).to(dtype), f(b, s, n).to(dtype),
                   f(b, s, n).to(dtype))
    return x, dt, A, B, C, init


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    rng = np.random.default_rng(s + n)
    for strided in (False, True):
        x, dt, A, B, C, init = _ssd_inputs(rng, b, s, h, p, n, dtype, cuda,
                                           strided)
        for st0 in (init, None):
            n0 = ss.ssd_scan_chunked.launches
            y, fin = ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                  initial_state=st0)
            torch.cuda.synchronize()
            assert ss.ssd_scan_chunked.launches == n0 + 1
            wy, wfin = ssd_scan_plain(x, dt, A, B, C, chunk, st0)
            assert y.dtype == dtype and fin.dtype == torch.float32
            assert _rel_err(y, wy) <= SSD_REL_TOL[dtype]
            assert _rel_err(fin, wfin) <= SSD_REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_state_chaining(cuda, dtype):
    """Two halves with the carried state equal one call over the whole."""
    x, dt, A, B, C, init = _ssd_inputs(np.random.default_rng(4), 2, 384, 24,
                                       64, 128, dtype, cuda)
    y, fin = ops.ssd_scan(x, dt, A, B, C, initial_state=init)
    y1, f1 = ops.ssd_scan(x[:, :200], dt[:, :200], A, B[:, :200],
                          C[:, :200], initial_state=init)
    y2, f2 = ops.ssd_scan(x[:, 200:], dt[:, 200:], A, B[:, 200:],
                          C[:, 200:], initial_state=f1)
    assert _rel_err(torch.cat([y1, y2], 1), y) <= SSD_REL_TOL[dtype]
    assert _rel_err(f2, fin) <= SSD_REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_decay_underflow(cuda, dtype):
    """Large dt |A| (~4.5 a step): cs falls to -370 .. -740 over a
    128-step chunk, so exp(-cs_s) alone would overflow and exp(cs_l - cs_s)
    underflows to 0 some 25 steps below the diagonal; outputs and state
    stay finite and match the plain version. (Much larger |cs| is no test
    of the kernel: both sides form cs_l - cs_s from fp32 cumsums, whose
    rounding, ulp(|cs|), then moves the dominant decays by more than
    1e-4.)"""
    rng = np.random.default_rng(6)
    x, dt, A, B, C, init = _ssd_inputs(rng, 2, 300, 8, 64, 128, dtype, cuda,
                                       strided=True)
    dt = dt + 1.0
    A = A * 2.0 - 1.0
    y, fin = ops.ssd_scan(x, dt, A, B, C, initial_state=init)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(fin).all())
    wy, wfin = ssd_scan_plain(x, dt, A, B, C, 128, init)
    assert _rel_err(y, wy) <= SSD_REL_TOL[dtype]
    assert _rel_err(fin, wfin) <= SSD_REL_TOL[torch.float32]


def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, init = _ssd_inputs(np.random.default_rng(5), 2, 32, 4,
                                       64, 16, torch.float32, cuda)
    n0 = ss.ssd_scan_chunked.launches
    with pytest.raises(ValueError):              # p not built
        ops.ssd_scan(x[..., :48], dt, A, B, C, chunk=16)
    with pytest.raises(ValueError):              # n not built
        ops.ssd_scan(x, dt, A, B[..., :12], C[..., :12], chunk=16)
    with pytest.raises(ValueError):              # chunk above 128
        ops.ssd_scan(x, dt, A, B, C, chunk=256)
    with pytest.raises(ValueError):              # x not packed in a row
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     B, C, chunk=16)
    with pytest.raises(TypeError):               # B in another dtype
        ops.ssd_scan(x, dt, A, B.to(torch.bfloat16), C, chunk=16)
    with pytest.raises(ValueError):              # state on the CPU
        ops.ssd_scan(x, dt, A, B, C, chunk=16, initial_state=init.cpu())
    # x, B and C as views one element off 16 bytes (base and row stride)
    xc = torch.zeros((2, 32, 4 * 64 + 2 * 16 + 1), device=cuda)
    with pytest.raises(ValueError):              # x not 16-byte aligned
        ops.ssd_scan(xc[..., 1:257].unflatten(-1, (4, 64)), dt, A, B, C,
                     chunk=16)
    with pytest.raises(ValueError):              # B, C not 16-byte aligned
        ops.ssd_scan(x, dt, A, xc[..., 257:273], xc[..., 273:289], chunk=16)
    assert ss.ssd_scan_chunked.launches == n0


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_models_greedy_tokens_kernels_on_equal_off(cuda, arch):
    """fp32 smoke models of the SSM and hybrid families: identical greedy
    continuations with the kernels on (ssd_scan in prefill; flash_prefill
    and flash_decode for the hybrid's attention) and off, and every cache
    leaf within 1e-4 of max |leaf| after the decode steps."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import LM
    cfg = smoke_variant(get_config(arch)).replace(d_model=128)
    outs, caches = [], []
    for on in (False, True):
        lm = LM(cfg.replace(use_kernels=on))
        params = lm.init(torch.Generator(device=cuda).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 40)), device=cuda)
        n0 = ss.ssd_scan_chunked.launches
        logits, cache = lm.prefill(params, {"tokens": toks}, max_len=48)
        assert (ss.ssd_scan_chunked.launches - n0) == (cfg.num_layers
                                                       if on else 0)
        seq = []
        for _ in range(8):
            tok = torch.argmax(logits, dim=-1)
            seq.append(tok)
            logits, cache = lm.decode_step(params, cache, tok)
        outs.append(torch.stack(seq, 1).cpu().numpy())
        caches.append(cache)
    np.testing.assert_array_equal(outs[0], outs[1])
    for key in caches[0]:
        if key != "pos":
            assert _rel_err(caches[1][key], caches[0][key]) <= 1e-4, key


# ---------------------------------------------------------------- step capture

def _smoke(arch, **kw):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(d_model=128, **kw)


def _shared_prompts(vocab, n=6):
    """Prompts of 32 over one 24-token prefix, two exact repeats."""
    rng = np.random.default_rng(9)
    pre = rng.integers(0, vocab, 24)
    prompts = [np.concatenate([pre, rng.integers(0, vocab, 8)])
               for _ in range(n - 2)]
    return prompts + [prompts[0], prompts[1]]


def _serve_engine(cuda, cfg, step_graphs, engine_kw, mode="continuous"):
    """Serve six requests (staggered one per tick in continuous mode, so
    paged prefix hits take the fused tick) on a fresh engine, kernels on.
    Returns (outputs, every backend's cache leaves and cur_tok, kernel
    launches counted from before the engine was built, engine)."""
    import time
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    ops.reset_launch_counts()
    eng = InProcessServingEngine(
        {"v": (cfg, 70.0)}, max_batch=3, prompt_len=32, max_new=8,
        decode_chunk=2, prefill_chunk=8, use_kernels=True, device=cuda,
        mode=mode, step_graphs=step_graphs, **engine_kw)
    eng.apply_allocation(0.0, {"v": 1})
    for i, p in enumerate(_shared_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=i, tokens=p, max_new=8, arrival=time.time()),
                   "v")
        if mode == "continuous":
            eng.step(0.0)
    eng.drain(0.0) if mode == "continuous" else eng.pump(0.0)
    torch.cuda.synchronize()
    b = eng.backends["v"]
    state = {**{k: t.clone() for k, t in b.cache.items()},
             "cur_tok": b.cur_tok.clone()}
    return ({r.rid: list(r.output) for r in eng.done}, state,
            ops.launch_counts(), eng)


GRAPH_ENGINES = [
    # label, arch, config overrides, engine kwargs, mode
    ("dense fp32", "tinyllama-1.1b", dict(num_layers=2), {}, "continuous"),
    ("dense bf16", "tinyllama-1.1b", dict(num_layers=2, dtype="bfloat16"),
     {}, "continuous"),
    ("dense pump", "tinyllama-1.1b", dict(num_layers=2), {}, "pump"),
    ("paged", "tinyllama-1.1b", dict(num_layers=2),
     dict(kv_cache="paged", kv_page_size=8), "continuous"),
    ("paged sharing, fused tick", "tinyllama-1.1b", dict(num_layers=2),
     dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True),
     "continuous"),
    ("mamba2", "mamba2-130m", {}, {}, "continuous"),
    ("mamba2 pump", "mamba2-130m", {}, {}, "pump"),
    ("hymba", "hymba-1.5b", {}, {}, "continuous"),
    ("dense chunked, fused tick", "tinyllama-1.1b", dict(num_layers=2),
     dict(scheduler="chunked"), "continuous"),
    ("dense async", "tinyllama-1.1b", dict(num_layers=2, dtype="bfloat16"),
     dict(async_tick=True), "continuous"),
    ("paged chunked async", "tinyllama-1.1b", dict(num_layers=2),
     dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True,
          scheduler="chunked", async_tick=True), "continuous"),
    ("mamba2 async", "mamba2-130m", {}, dict(async_tick=True), "continuous"),
    # gemma-2b's head shape: MQA with G 8 at hd 256, GeGLU, tied embedding
    ("gemma hd256 dense bf16", "gemma-2b",
     dict(num_layers=2, num_heads=8, head_dim=256, dtype="bfloat16"), {},
     "continuous"),
    ("gemma hd256 paged sharing", "gemma-2b",
     dict(num_layers=2, num_heads=8, head_dim=256),
     dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True),
     "continuous"),
    ("gemma hd256 chunked", "gemma-2b",
     dict(num_layers=2, num_heads=8, head_dim=256),
     dict(scheduler="chunked"), "continuous"),
    # both fused ticks in bf16 at hd 256: the chunk forms' tensor-core route
    ("gemma hd256 chunked bf16, tensor-core fused tick", "gemma-2b",
     dict(num_layers=2, num_heads=8, head_dim=256, dtype="bfloat16"),
     dict(scheduler="chunked"), "continuous"),
    ("gemma hd256 paged sharing bf16, tensor-core fused tick", "gemma-2b",
     dict(num_layers=2, num_heads=8, head_dim=256, dtype="bfloat16"),
     dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True),
     "continuous"),
    # granite-moe's MoE FFN (routing, sort, dispatch and combine captured)
    # at its GQA group of 3; the last at capacity factor 1.0, so a
    # prefill's experts overflow inside the captured step
    ("granite moe dense bf16", "granite-moe-3b-a800m",
     dict(num_layers=2, num_heads=6, num_kv_heads=2, dtype="bfloat16"), {},
     "continuous"),
    ("granite moe paged sharing", "granite-moe-3b-a800m",
     dict(num_layers=2, num_heads=6, num_kv_heads=2),
     dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True),
     "continuous"),
    ("granite moe chunked overflowing", "granite-moe-3b-a800m",
     dict(num_layers=2, num_heads=6, num_kv_heads=2, num_experts=8,
          moe_capacity_factor=1.0),
     dict(scheduler="chunked"), "continuous"),
]


@pytest.mark.parametrize("label,arch,over,engine_kw,mode", GRAPH_ENGINES)
def test_step_graph_replays_equal_eager_steps(cuda, label, arch, over,
                                             engine_kw, mode):
    """The engine replaying captured steps against the same engine run op
    by op (``step_graphs=False``), kernels on: bitwise-equal per-request
    tokens and every cache leaf, the same kernel launches counted (warm-up
    included: the capture's own counts are taken back), and the arrival
    counters of the capture stream's workspace back at zero. The page
    pool's trash page 0 is the one exception: inert rows and padded chunk
    tokens all write into it at the same offsets, so which write lands
    there depends on scatter order on either path; no live row reads it."""
    cfg = _smoke(arch, **over)
    got, state, launches, eng = _serve_engine(cuda, cfg, True, engine_kw,
                                              mode)
    want, ref_state, ref_launches, _ = _serve_engine(cuda, cfg, False,
                                                     engine_kw, mode)
    assert len(want) == 6 and got == want
    assert state.keys() == ref_state.keys()
    for k in state:
        if k in ("kp", "vp"):       # pool (L, KV, P, page, hd): by page
            diff = (state[k] != ref_state[k]).flatten(3).any(-1).any(1)
            assert set(diff.any(0).nonzero().flatten().tolist()) <= {0}, k
        else:
            assert torch.equal(state[k], ref_state[k]), k
    assert launches == ref_launches and sum(launches.values()) > 0
    b = eng.backends["v"]
    assert b.graphs and all(g.graph is not None for g in b.graphs.values())
    if engine_kw.get("kv_prefix_sharing"):
        assert eng.kv_pool_stats()["prefix_hits"] > 0
    if b.chunked:
        assert ("fused", 3) in b.graphs
    stream = capture_stream(cuda)
    ws = build.workspace_buffers(stream.device, stream.cuda_stream)
    assert ws is not None and int(ws[1].abs().sum()) == 0


def test_step_graph_raises_on_a_moved_tensor_and_a_missing_shape(cuda):
    from repro_torch.serving.engine import VariantBackend
    from repro_torch.serving.graphs import StepGraphError
    cfg = _smoke("tinyllama-1.1b", num_layers=2)
    b = VariantBackend("v", cfg, 70.0, max_batch=2, prompt_len=16,
                       max_new=4, decode_chunk=2, use_kernels=True,
                       device=cuda)
    with pytest.raises(StepGraphError):          # no graph at this length
        b.generate(np.zeros((2, 17), np.int64), 2)
    b._step("chunk", None)
    b.cache["k"] = b.cache["k"].clone()          # replaced, not in place
    with pytest.raises(StepGraphError, match="replaced"):
        b._step("chunk", None)


def test_a_capture_runs_with_the_cyclic_collector_off(cuda):
    """A collection inside a capture could free a dead engine's graph held
    by a reference cycle, and destroying a graph invalidates the capture in
    progress (the replay test above once failed so); the step runs with
    the collector off while it is captured, and it is back on after."""
    import gc
    from repro_torch.serving.graphs import StepGraph
    x = torch.ones(4, device=cuda)
    seen = []

    def step(a):
        seen.append(gc.isenabled())
        return a + 1

    g = StepGraph("gc", step, {"a": x}, lambda: [], torch.cuda.Stream(cuda))
    g.capture(torch.cuda.graph_pool_handle())
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(g.run(a=x), x + 1)


def test_workspace_refuses_to_grow_during_capture(cuda):
    """A kernel workspace that would have to grow inside a capture raises
    (the graph would bake in a buffer the growth frees)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    s = torch.cuda.Stream(dev)
    ws = build.workspace_buffers(dev, s.cuda_stream)
    rows = (ws[1].numel() if ws else 0) + 1
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=s):
            build.workspace(dev, s.cuda_stream, 1, rows)
    B = rows // 4 + 1                            # B * KV arrival counters
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, 4, 8, 64), torch.bfloat16, dev)
    k = _randn(rng, (B, 4, 16, 64), torch.bfloat16, dev)
    bias = torch.zeros((B, 16), device=dev)
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=s):
            fd.flash_decode_bkhd(q, k, k, bias)


def test_a_retired_variant_leaves_no_device_memory(cuda):
    """Load a variant, serve, retire it: after the first cycle (which makes
    what the process keeps: cuBLAS's and the kernels' workspaces on the
    capture stream), three more cycles end at the same allocated bytes —
    the graphs, their pool, the caches and the weights go with it."""
    import gc
    import time
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = _smoke("tinyllama-1.1b", num_layers=2)
    eng = InProcessServingEngine(
        {"v": (cfg, 70.0)}, max_batch=3, prompt_len=32, max_new=8,
        decode_chunk=2, kv_cache="paged", kv_page_size=8,
        kv_prefix_sharing=True, prefill_chunk=8, use_kernels=True,
        device=cuda)

    def cycle():
        eng.apply_allocation(0.0, {"v": 1})
        for i, p in enumerate(_shared_prompts(cfg.vocab_size)):
            eng.submit(Request(rid=i, tokens=p, max_new=8,
                               arrival=time.time()), "v")
            eng.step(0.0)
        eng.drain(0.0)
        eng.apply_allocation(0.0, {})
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    base = cycle()
    assert [cycle() for _ in range(3)] == [base] * 3


def test_a_failed_capture_raises(cuda):
    """A step that syncs with the host cannot be captured: the capture
    raises and the step stays unusable (no eager fallback). Last in the
    file: a failed capture may leave its stream's pool routing behind."""
    from repro_torch.serving.graphs import StepGraph, StepGraphError
    x = torch.ones(4, device=cuda)
    g = StepGraph("sync", lambda a: a.sum().item(), {"a": x}, lambda: [],
                  torch.cuda.Stream(cuda))
    with pytest.raises(RuntimeError):
        g.capture(torch.cuda.graph_pool_handle())
    with pytest.raises(StepGraphError, match="never captured"):
        g.run(a=x)


# ------------------------------------------- async tick, chunked, preemption

def _virtual_serve(cuda, engine_kw, n=8, tight=False, layers=2,
                   dtype="float32"):
    """Staggered requests on a virtual clock (one per tick, tight SLOs on
    even rids with ``tight``) through a 2-layer tinyllama engine, kernels
    on, steps replayed. Returns (rid -> (backend, tokens, dropped,
    preemptions), engine)."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = _smoke("tinyllama-1.1b", num_layers=layers, dtype=dtype)
    t = [0.0]
    eng = InProcessServingEngine(
        {"v": (cfg, 70.0)}, max_batch=3, prompt_len=32, max_new=8,
        decode_chunk=2, prefill_chunk=8, use_kernels=True, device=cuda,
        clock=lambda: t[0], **engine_kw)
    eng.apply_allocation(0.0, {"v": 1})
    prompts = _shared_prompts(cfg.vocab_size, n)
    rng = np.random.default_rng(2)
    for i, p in enumerate(prompts):
        slo = (30.0 if i % 2 == 0 else 5000.0) if tight else 0.0
        eng.submit(Request(rid=i, tokens=p, max_new=int(rng.integers(2, 9)),
                           arrival=t[0], slo_ms=slo), "v")
        eng.step(t[0])
        t[0] += 0.05
    for _ in range(400):
        if not eng.backlog(t[0]) and not eng.in_flight():
            break
        eng.step(t[0])
        t[0] += 0.05
    torch.cuda.synchronize()
    for b in eng.backends.values():
        assert b._pending is None and not b._uncommitted_done
        assert all(r is None for r in b.slot_req)
        if hasattr(b, "pool"):
            b.pool.assert_invariants()
            assert b.pool.used_pages == 0
    return ({r.rid: (r.backend, list(r.output), r.dropped, r.preemptions)
             for r in eng.done}, eng)


ASYNC_CASES = [
    dict(),
    dict(scheduler="chunked"),
    dict(scheduler="chunked", preemption="requeue"),
    dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True),
    dict(kv_cache="paged", kv_page_size=8, kv_prefix_sharing=True,
         scheduler="chunked", preemption="requeue"),
]


@pytest.mark.parametrize("engine_kw", ASYNC_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items())
                         or "dense fifo")
def test_async_tick_equals_sync_on_the_card(cuda, engine_kw):
    """The async tick against the sync tick on one workload, bitwise per
    request; the async commit reads pinned host buffers behind CUDA events
    (never a stream synchronise)."""
    tight = engine_kw.get("preemption", "none") != "none"
    want, _ = _virtual_serve(cuda, engine_kw, tight=tight)
    got, eng = _virtual_serve(cuda, dict(engine_kw, async_tick=True),
                              tight=tight)
    assert len(want) == 8 and got == want
    b = eng.backends["v"]
    assert b.chunked                 # async admits through the fused tick
    bufs = [t for ts in b._readback._bufs.values() for t in ts]
    assert bufs and all(t.is_pinned() for t in bufs)
    assert b.commit_wait_ms >= 0.0 and b.hidden_host_ms >= 0.0
    if tight:
        assert any(o[3] for o in got.values())


@pytest.mark.parametrize("scheduler", ["edf", "chunked"])
@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_preemption_resume_on_the_card(cuda, kv_cache, scheduler):
    """Three hopeless requests take the slots, five feasible ones arrive and
    preempt them (requeue); each resume is a chunked prefill of prompt +
    preserved tokens through the chunk kernels. Every request finishes
    with the unpressured run's tokens (fp32), and the pool ends empty."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = _smoke("tinyllama-1.1b", num_layers=2)
    prompts = _shared_prompts(cfg.vocab_size, 8)
    outs = []
    for preemption in ("none", "requeue"):
        eng = InProcessServingEngine(
            {"v": (cfg, 70.0)}, max_batch=3, prompt_len=32, max_new=8,
            decode_chunk=2, prefill_chunk=8, use_kernels=True, device=cuda,
            kv_cache=kv_cache, kv_page_size=8, scheduler=scheduler,
            preemption=preemption, clock=lambda: 0.0)
        eng.apply_allocation(0.0, {"v": 1})
        for i in range(3):
            eng.submit(Request(rid=i, tokens=prompts[i], max_new=8,
                               arrival=0.0, slo_ms=1.0), "v")
        eng.step(100.0)                  # admit the hopeless three
        for i in range(3, 8):
            eng.submit(Request(rid=i, tokens=prompts[i], max_new=8,
                               arrival=0.0, slo_ms=1e9), "v")
        eng.drain(100.0)
        torch.cuda.synchronize()
        b = eng.backends["v"]
        if hasattr(b, "pool"):
            b.pool.assert_invariants()
            assert b.pool.used_pages == 0
        if preemption != "none":
            assert eng.metrics.value("requests.preempted") > 0
        outs.append({r.rid: list(r.output) for r in eng.done})
    assert len(outs[0]) == 8 and outs[1] == outs[0]


def test_dense_fused_tick_launches_one_chunk_kernel_per_layer(cuda):
    """Every dense fused tick runs flash_decode's chunk form once per layer
    and the one-token decode kernel never (replayed or eager alike)."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import VariantBackend
    cfg = _smoke("tinyllama-1.1b", num_layers=3)
    for graphs in (True, False):
        b = VariantBackend("v", cfg, 70.0, max_batch=3, prompt_len=32,
                           max_new=8, decode_chunk=2, use_kernels=True,
                           device=cuda, chunked=True, prefill_chunk_tokens=8,
                           step_graphs=graphs)
        b.admit_chunked([Request(rid=i, tokens=np.arange(20 + i), max_new=8,
                                 arrival=0.0) for i in range(3)], 0.0)
        ticks = 0
        while b._prefilling:
            n0 = ops.launch_counts()
            b.fused_chunk_step(0.0)
            n1 = ops.launch_counts()
            assert n1["flash_decode_chunk"] - n0["flash_decode_chunk"] == 3
            assert n1["flash_decode"] == n0["flash_decode"]
            ticks += 1
        assert ticks == 3                    # 22 tokens in chunks of 8
        b.close()


# ------------------------------------------------------ speculative decoding

SPEC_K = 4
SPEC_CAP = 512 + 64 + SPEC_K + 2     # the drafter's ring: 582, not 64-aligned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ck", [SPEC_K + 1, 1])
def test_chunk_forms_at_the_verify_shapes(cuda, ck, dtype):
    """Both chunk forms at a speculative round's shapes, against their
    plain versions: the verify at ck = k + 1 and the drafter's resync at
    ck = 1, over the drafter's 582-slot ring (dense) and 37-page tables of
    16 (paged), queries at offsets past a 512-token prompt (row 1 inert at
    0, as the resync's rows that accepted less than every draft)."""
    rng = np.random.default_rng(ck)
    B, KV, G, hd, ps = 8, 4, 8, 64, 16
    width = -(-SPEC_CAP // ps)
    start = torch.as_tensor(rng.integers(512, SPEC_CAP - ck, B))
    start[1] = 0
    pos = start[:, None] + torch.arange(ck)[None, :]
    bias = torch.where(torch.arange(SPEC_CAP)[None, None, :]
                       <= pos[:, :, None], 0.0, -1e9).float().to(cuda)
    q = _randn(rng, (B, ck, KV, G, hd), dtype, cuda)
    k = _randn(rng, (B, KV, SPEC_CAP, hd), dtype, cuda)
    v = _randn(rng, (B, KV, SPEC_CAP, hd), dtype, cuda)
    n0 = fd.flash_decode_chunk.launches
    out = fd.flash_decode_chunk(q, k, v, bias)
    torch.cuda.synchronize()
    assert fd.flash_decode_chunk.launches == n0 + 1
    torch.testing.assert_close(
        out.float(), fd.flash_decode_chunk_plain(q, k, v, bias).float(),
        atol=TOL[dtype], rtol=0)
    P = B * width + 1
    kp = _randn(rng, (KV, P, ps, hd), dtype, cuda)
    vp = _randn(rng, (KV, P, ps, hd), dtype, cuda)
    tables = torch.as_tensor(rng.permutation(np.arange(1, P)).reshape(
        B, width), dtype=torch.int32, device=cuda)
    lengths = torch.clamp(pos + 1, 1, width * ps).to(torch.int32).to(cuda)
    n0 = pd.paged_flash_decode_bkhd.launches
    out = pd.paged_flash_decode_chunk(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert pd.paged_flash_decode_bkhd.launches == n0 + 1
    want = pd.paged_flash_decode_chunk_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _spec_serve(cuda, step_graphs, kv_cache, speculative="small:big",
                async_tick=False):
    """Eight staggered requests on a virtual clock through a speculative
    engine (drafter "small" 1 layer, verifier "big" 3 layers, fp32, kernels
    on, k = SPEC_K; ``speculative=None`` serves "big" alone). Returns
    (rid -> tokens, verifier and drafter cache leaves and cur_tok, engine)."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    variants = {"small": (_smoke("tinyllama-1.1b", num_layers=1), 70.0),
                "big": (_smoke("tinyllama-1.1b", num_layers=3), 75.0)}
    t = [0.0]
    eng = InProcessServingEngine(
        variants, max_batch=3, prompt_len=32, max_new=12, decode_chunk=2,
        prefill_chunk=8, use_kernels=True, device=cuda, kv_cache=kv_cache,
        kv_page_size=8, speculative=speculative, spec_k=SPEC_K,
        async_tick=async_tick, step_graphs=step_graphs, clock=lambda: t[0])
    eng.apply_allocation(0.0, {"big": 1})
    rng = np.random.default_rng(4)
    for i, p in enumerate(_shared_prompts(variants["big"][0].vocab_size, 8)):
        eng.submit(Request(rid=i, tokens=p, max_new=int(rng.integers(2, 13)),
                           arrival=t[0]), "big")
        eng.step(t[0])
        t[0] += 0.05
    eng.drain(t[0])
    torch.cuda.synchronize()
    b = eng.backends["big"]
    parts = [("verifier", b)]
    if b._spec_pair is not None:
        parts.append(("drafter", b._spec_pair.d))
    # a retired paged row decodes from the trash page 0, whose contents
    # depend on the scatter order of colliding writes: its token is not
    # compared
    state = {n: {**{k: t.clone() for k, t in x.cache.items()},
                 "cur_tok": (torch.where((x.cache["pt"] != 0).any(1),
                                         x.cur_tok, -1)
                             if "pt" in x.cache else x.cur_tok.clone())}
             for n, x in parts}
    for _, x in parts:
        if hasattr(x, "pool"):
            x.pool.assert_invariants()
            assert x.pool.used_pages == 0
    return {r.rid: list(r.output) for r in eng.done}, state, eng


@pytest.mark.parametrize("kv_cache,async_tick", [("dense", False),
                                                 ("dense", True),
                                                 ("paged", True)])
def test_speculative_replay_equals_eager(cuda, kv_cache, async_tick):
    """Speculative rounds replayed (the verify, the drafter's resync, draft
    chunks and bootstrap chunks as CUDA graphs) against the same engine op
    by op: bitwise-equal tokens and every cache leaf of verifier and
    drafter (paged: all but the trash page 0); at fp32 both equal the
    verifier's target-only greedy tokens."""
    got, state, eng = _spec_serve(cuda, True, kv_cache, async_tick=async_tick)
    want, ref_state, _ = _spec_serve(cuda, False, kv_cache,
                                     async_tick=async_tick)
    target, _, _ = _spec_serve(cuda, True, kv_cache, speculative=None)
    assert len(want) == 8 and got == want == target
    for n in state:
        for k in state[n]:
            a, b = state[n][k], ref_state[n][k]
            if k in ("kp", "vp"):
                diff = (a != b).flatten(3).any(-1).any(1)
                assert set(diff.any(0).nonzero().flatten().tolist()) <= {0}
            else:
                assert torch.equal(a, b), (n, k)
    assert eng.metrics.value("spec.rounds") > 0


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_speculative_steps_launch_the_chunk_kernels(cuda, kv_cache):
    """The captured verify is one chunk-form launch per verifier layer and
    the drafter's resync one per drafter layer; the draft chunk is k
    decode-form launches per drafter layer; a round after the first
    launches the three together."""
    _, _, eng = _spec_serve(cuda, True, kv_cache)
    b = eng.backends["big"]
    d = b._spec_pair.d
    chunk_key, dec_key = (("paged_decode", "paged_decode")
                          if kv_cache == "paged"
                          else ("flash_decode_chunk", "flash_decode"))
    assert b.graphs[("verify", 3)].launches == {chunk_key: 3}
    assert d.graphs[("resync", 3)].launches == {chunk_key: 1}
    draft = [g for (name, _), g in d.graphs.items() if name == "chunk"]
    assert draft and all(g.launches == {dec_key: SPEC_K} for g in draft)
    from repro_torch.serving.api import Request
    for i in range(2):
        eng.submit(Request(rid=100 + i, tokens=np.arange(32) + i, max_new=12,
                           arrival=0.0), "big")
    eng.step(0.0)                       # admit (monolithic) + round 1
    n0 = ops.launch_counts()
    eng.step(0.0)                       # one later round
    n1 = ops.launch_counts()
    got = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
    want = {chunk_key: 3 + 1}
    want[dec_key] = want.get(dec_key, 0) + SPEC_K
    assert got == want


# ----------------------------------------------------------- observability
OBS_ENGINES = [
    ("dense fifo", {}),
    ("paged chunked async", dict(kv_cache="paged", kv_page_size=8,
                                 kv_prefix_sharing=True, scheduler="chunked",
                                 preemption="requeue", async_tick=True)),
]


def _counting_events(monkeypatch):
    """Count every CUDA event the engine constructs from here on."""
    made = []

    class Event(torch.cuda.Event):
        def __new__(cls, *a, **kw):
            made.append(1)
            return super().__new__(cls, *a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    return made


@pytest.mark.parametrize("label,engine_kw", OBS_ENGINES)
def test_obs_trace_adds_no_kernel_and_changes_no_token(cuda, monkeypatch,
                                                     label, engine_kw):
    """One workload, steps replayed, with observability off, traced, and
    traced with every tick fenced (``profile_dispatch=1``): bitwise-equal
    tokens and equal kernel launches (the trace's hooks are host code
    around the replays), the captured tensors never replaced (every
    graph's pointer check passes after the run), and the profiler's CUDA
    events are the only events tracing adds: one per fenced step."""
    from repro_torch.obs import Observability
    tight = engine_kw.get("preemption", "none") != "none"
    runs = {}
    for mode, kw in (("off", dict(obs=Observability.disabled())),
                     ("traced", dict(trace=True)),
                     ("fenced", dict(trace=True, profile_dispatch=1))):
        made = _counting_events(monkeypatch)
        ops.reset_launch_counts()
        got, eng = _virtual_serve(cuda, dict(engine_kw, **kw), tight=tight)
        runs[mode] = (got, ops.launch_counts(), len(made), eng)
        monkeypatch.undo()
    for mode in ("traced", "fenced"):
        assert runs[mode][0] == runs["off"][0], mode
        assert runs[mode][1] == runs["off"][1], mode
    assert sum(runs["off"][1].values()) > 0
    assert runs["traced"][2] == runs["off"][2]
    eng = runs["fenced"][3]
    recs = eng.tracer.ticks
    fenced = [r for r in recs if np.isfinite(r.dispatch_ms)]
    assert fenced and all(r.kind != "idle" for r in fenced)
    assert runs["fenced"][2] - runs["off"][2] == len(fenced)
    for r in fenced:
        assert r.device_ms > 0.0 and r.dispatch_ms > 0.0
        assert r.host_sync_ms >= 0.0
        assert r.dispatch_ms + r.device_ms + r.host_sync_ms \
            <= r.exec_ms + 1e-3
    for mode in ("traced", "fenced"):
        b = runs[mode][3].backends["v"]
        assert b.graphs
        for g in b.graphs.values():
            assert g.graph is not None
            g._check_state()


def test_dispatch_profiler_unfenced_ticks_record_no_event(cuda, monkeypatch):
    """``profile_dispatch=3``: every third tick fenced, the others NaN; the
    events the profiler adds over a traced run are exactly the fenced
    ticks' (the async tick's read-back events aside, which both runs make
    alike)."""
    base = _counting_events(monkeypatch)
    want, _ = _virtual_serve(cuda, dict(trace=True, async_tick=True))
    monkeypatch.undo()
    made = _counting_events(monkeypatch)
    got, eng = _virtual_serve(cuda, dict(trace=True, async_tick=True,
                                         profile_dispatch=3))
    monkeypatch.undo()
    assert got == want
    recs = eng.tracer.ticks
    fenced = [i for i, r in enumerate(recs) if np.isfinite(r.dispatch_ms)]
    assert fenced and all((i + 1) % 3 == 0 for i in fenced)
    assert len(made) - len(base) == len(fenced)
    assert all(recs[i].device_ms > 0.0 for i in fenced)


# ------------------------------------------------------------- profiling

def _profile_engine(cuda, layers=(2, 4), **kw):
    from repro_torch.serving.engine import InProcessServingEngine
    variants = {f"L{n}": (_smoke("tinyllama-1.1b", num_layers=n), 70.0 + n)
                for n in layers}
    kw = {**dict(max_batch=4, prompt_len=32, max_new=8, decode_chunk=4,
                 use_kernels=True, device=cuda), **kw}
    return InProcessServingEngine(variants, **kw)


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_profiler_sweep_on_the_card(cuda, kv_cache):
    """An ``EngineProfiler`` sweep of a two-rung ladder, steps replayed as
    CUDA graphs: every rung's fitted capacity grows with its units
    (th(4) > th(1)), every point counts its requests, and the sweep
    launched the path's kernels."""
    from repro_torch.profiling.measure import EngineProfiler
    eng = _profile_engine(cuda, kv_cache=kv_cache, kv_page_size=8)
    ops.reset_launch_counts()
    got = EngineProfiler(eng, points=(1, 2, 4), requests_per_point=8,
                         warmup=4, vocab=128).profile_all()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert sorted(got) == ["L2", "L4"]
    for m in got.values():
        assert [p.units for p in m.points] == [1, 2, 4]
        assert all(p.n_requests >= 8 for p in m.points)
        assert m.profile.throughput(4) > m.profile.throughput(1)
        assert 0.0 <= m.th_fit.r_squared <= 1.0
        assert m.readiness_s > 0.0
    decode = "paged_decode" if kv_cache == "paged" else "flash_decode"
    assert launches["flash_prefill"] > 0 and launches[decode] > 0
    assert not eng.backends


def test_throwaway_sweep_releases_its_graphs_and_memory(cuda):
    """After a throwaway's sweep its graphs are dropped and
    ``memory_allocated`` is back within 5% of where it stood before the
    throwaway was built (a first sweep makes what the process keeps: the
    libraries' and the kernels' workspaces). The rung is full width at 2
    layers, so the throwaway itself holds hundreds of MB."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.profiling.measure import EngineProfiler
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = get_config("tinyllama-1.1b").replace(num_layers=2, name="w")
    eng = InProcessServingEngine({"w": (cfg, 70.0)}, max_batch=4,
                                 prompt_len=64, max_new=8, decode_chunk=4,
                                 use_kernels=True, device=cuda)
    built, held = [], []
    make = eng._make_backend

    def make_logged(name):
        b = make(name)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        built.append(b)
        return b
    eng._make_backend = make_logged
    prof = EngineProfiler(eng, points=(1, 2), requests_per_point=4, warmup=2)
    prof.profile_variant("w")
    built.clear()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    prof.profile_variant("w")
    (tb,) = built
    built.clear()
    assert not tb.graphs and not tb._steps
    del tb
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert held[-1] - base > 200e6          # the throwaway's own footprint
    assert abs(after - base) <= 0.05 * base, (base, held[-1], after)


def test_live_backend_profiled_in_place_on_the_card(cuda):
    """A loaded variant is profiled in place: its captured graphs stay (and
    pass their pointer checks), its slot cap is restored, and it serves
    afterwards with every request complete."""
    import time
    from repro_torch.profiling.measure import EngineProfiler
    from repro_torch.serving.api import Request
    eng = _profile_engine(cuda, layers=(2,), enforce_units=True)
    eng.apply_allocation(0.0, {"L2": 2})
    b = eng.backends["L2"]
    graphs = dict(b.graphs)
    assert graphs and b.slot_cap == 2
    m = EngineProfiler(eng, points=(1, 2, 4), requests_per_point=4,
                       warmup=2, vocab=128).profile_variant("L2")
    assert [p.units for p in m.points] == [1, 2, 4]
    assert eng.backends["L2"] is b and b.slot_cap == 2
    assert b.graphs == graphs
    for g in b.graphs.values():
        assert g.graph is not None
        g._check_state()
    rng = np.random.default_rng(4)
    for i in range(6):
        eng.submit(Request(rid=i, tokens=rng.integers(0, 128, 32),
                           max_new=8, arrival=time.time()), "L2")
    eng.drain(0.0)
    assert len(eng.done) == 6 and all(len(r.output) == 8 for r in eng.done)


# ------------------------------------------------------------ replica fabric
def _fabric_engine(cuda, cfg, n_nodes=2, node_cap=2, **kw):
    """A fabric of ``n_nodes`` nodes (spread, single-unit replicas, p2c)
    over the one variant "v" of ``cfg``, kernels on, steps replayed."""
    from repro_torch.cluster import make_nodes
    from repro_torch.serving.engine import InProcessServingEngine
    kw = {**dict(max_batch=3, prompt_len=32, max_new=8, decode_chunk=2,
                 prefill_chunk=8), **kw}
    return InProcessServingEngine(
        {"v": (cfg, 70.0)}, use_kernels=True, device=cuda,
        nodes=make_nodes(n_nodes, node_cap), placement="spread", **kw)


def _fabric_requests(vocab, n, arrival=0.0):
    from repro_torch.serving.api import Request
    rng = np.random.default_rng(11)
    return [Request(rid=i, tokens=rng.integers(0, vocab, 32), max_new=8,
                    arrival=arrival) for i in range(n)]


def test_fabric_killed_replica_memory_is_released(cuda):
    """A node crash closes its replica: the backend object is collected
    (nothing holds it: not the fabric, the router, a pending record or a
    graph), and ``memory_allocated`` falls by at least 90% of its weights
    and KV cache. Full width at 2 layers, so a replica holds hundreds of
    MB."""
    import gc
    import time
    import weakref
    from repro_torch.cluster import node_crash
    from repro_torch.configs import get_config
    from repro_torch.serving.graphs import tensor_leaves
    cfg = get_config("tinyllama-1.1b").replace(num_layers=2, name="v")
    eng = _fabric_engine(cuda, cfg, max_batch=4, prompt_len=64)
    eng.apply_allocation(0.0, {"v": 2})
    for r in _fabric_requests(cfg.vocab_size, 8, time.time()):
        assert eng.submit(r, "v")
    eng.step(0.0)                               # both replicas hold work
    (rid,) = [r.rid for r in eng.fabric.replicas.values()
              if r.node_id == "node0"]
    b = eng.backends[rid]
    own = sum(t.numel() * t.element_size()
              for t in tensor_leaves(b.params) + tensor_leaves(b.cache))
    alive = weakref.ref(b)
    del b
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.inject_fault(time.time(), node_crash(time.time(), "node0"))
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert alive() is None
    assert own > 200e6
    assert before - after >= 0.9 * own, (before, after, own)
    eng.drain(0.0)
    assert sorted(r.rid for r in eng.done) == list(range(8))


@pytest.mark.parametrize("kv", [{}, dict(kv_cache="paged", kv_page_size=16,
                                         kv_prefix_sharing=True)],
                         ids=["dense", "paged"])
def test_engine_close_returns_memory_to_its_start(cuda, kv):
    """C1: after ``apply_allocation(t, {})``, a collection and an emptied
    cache, ``memory_allocated`` is back at the engine's start within 0.1
    GB while the engine object lives on: granite-moe at full width cut to
    2 and 4 layers, 1.7 GB of weights and cache. The margin is what the
    first engine of a process leaves on the one capture stream for good
    (cuBLAS's workspace, 33.8 MB on the H100, and the kernels')."""
    import gc
    import time
    from repro_torch.configs import get_config
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    from repro_torch.serving.graphs import tensor_leaves
    base = get_config("granite-moe-3b-a800m")
    variants = {f"L{n}": (base.replace(num_layers=n, name=f"L{n}"), 70.0)
                for n in (2, 4)}
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    eng = InProcessServingEngine(variants, max_batch=4, prompt_len=64,
                                 max_new=8, decode_chunk=2, use_kernels=True,
                                 device=cuda, **kv)
    eng.apply_allocation(0.0, {n: 1 for n in variants})
    own = sum(t.numel() * t.element_size() for b in eng.backends.values()
              for t in tensor_leaves(b.params) + tensor_leaves(b.cache))
    rng = np.random.default_rng(4)
    for i in range(8):
        eng.submit(Request(rid=i, tokens=rng.integers(0, base.vocab_size, 64),
                           max_new=8, arrival=time.time()),
                   f"L{2 + 2 * (i % 2)}")
    eng.drain(0.0)
    eng.apply_allocation(0.0, {})
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert own > 1.5e9 and len(eng.done) == 8
    assert left <= 0.1e9, (left, own)


def test_apply_moe_on_the_card_equals_the_cpu(cuda):
    """``apply_moe`` at granite's routing (40 experts, top 8) in fp32 on
    the card against the CPU within 1e-4 of the output's scale: a decode
    step's 8 tokens (dropless, also against the dense oracle) and 512
    tokens at capacity factor 1.0, where experts overflow and slot 0 of
    each overflowing expert reads zero in the card's buffer."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-3b-a800m").replace(
        d_model=256, d_ff=128, dtype="float32")
    gen = torch.Generator().manual_seed(3)
    cpu = moe.init_moe(gen, cfg, torch.float32, torch.float32,
                       torch.device("cpu"))
    card = {n: t.to(cuda) for n, t in cpu.items()}
    for shape, cf in (((8, 1), None), ((2, 256), 1.0)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen)
        want, m_cpu = moe.apply_moe(cfg, cpu, x, capacity_factor=cf)
        got, m_card = moe.apply_moe(cfg, card, x.to(cuda),
                                    capacity_factor=cf)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        for n in m_cpu:
            assert float(m_card[n]) == pytest.approx(float(m_cpu[n]),
                                                     rel=1e-5, abs=1e-6)
        if cf is None:
            assert float(m_card["drop_fraction"]) == 0.0
            oracle = moe.apply_moe_dense_oracle(cfg, card, x.to(cuda))
            assert float((got - oracle).abs().max()) <= 1e-4 * scale
            continue
        assert float(m_card["drop_fraction"]) > 0.0
        T = x.shape[0] * x.shape[1]
        C = moe.moe_capacity(T, cfg, cf)
        flat = x.to(cuda).reshape(T, -1)
        ids = moe.route(cfg, card, flat)[2].reshape(-1)
        buf, *_, counts = moe._dispatch(flat, ids, cfg.num_experts, C,
                                        cfg.experts_per_token)
        over = counts > C
        assert bool(over.any()) and float(buf[over, 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fabric_replicas_replay_equal_tokens(cuda, dtype):
    """Two replicas of one variant, each its own seeded weights and its own
    captured graphs, give each request the tokens one backend of the
    variant gives it: the graphs run at ``max_batch``, so a row's
    arithmetic does not depend on its neighbours."""
    import time
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = _smoke("tinyllama-1.1b", num_layers=2, dtype=dtype)
    eng = _fabric_engine(cuda, cfg)
    eng.apply_allocation(0.0, {"v": 2})
    one = InProcessServingEngine({"v": (cfg, 70.0)}, max_batch=3,
                                 prompt_len=32, max_new=8, decode_chunk=2,
                                 use_kernels=True, device=cuda)
    one.apply_allocation(0.0, {"v": 1})
    for e in (eng, one):
        for i, r in enumerate(_fabric_requests(cfg.vocab_size, 9,
                                               time.time())):
            assert e.submit(r, "v")
            if i % 2:
                e.step(0.0)
        e.drain(0.0)
    got = {r.rid: list(r.output) for r in eng.done}
    want = {r.rid: list(r.output) for r in one.done}
    assert len(got) == 9 and got == want
    assert {r.backend for r in eng.done} == {"v#0", "v#1"}
    assert all(b.graphs for b in eng.backends.values())


def test_fabric_crash_during_an_async_tick_commits_it_once(cuda):
    """With the async tick the crashed replica holds a dispatched tick: the
    crash commits it (its finished rows complete there, once) and closes
    the backend, whose steps are never run again; the rest retry on the
    survivor and every request completes exactly once."""
    import time
    from repro_torch.cluster import node_crash
    cfg = _smoke("tinyllama-1.1b", num_layers=2)
    eng = _fabric_engine(cuda, cfg, async_tick=True)
    eng.apply_allocation(0.0, {"v": 2})
    for r in _fabric_requests(cfg.vocab_size, 10, time.time()):
        eng.submit(r, "v")
    for _ in range(3):
        eng.step(0.0)
    killed = eng.backends["v#0"]
    assert killed._pending is not None              # a tick in flight
    runs = []
    step = killed._step
    killed._step = lambda *a, **k: runs.append(a) or step(*a, **k)
    eng.inject_fault(time.time(), node_crash(time.time(), "node0"))
    assert killed._pending is None and not killed.graphs
    assert "v#0" not in eng.backends and eng.capacity_factor(0.0) == 0.5
    eng.drain(0.0)
    eng.flush_pending(0.0)
    assert runs == []
    rids = [r.rid for r in eng.done]
    assert sorted(rids) == list(range(10))          # each exactly once
    assert all(len(r.output) == 8 for r in eng.done)


def test_fabric_slow_factor_stretches_a_decode_commit(cuda):
    """A replica slowed 3x: each of its decode commits ends at least 2.5x
    its dispatch-to-read time after dispatch (the sleep scales the chunk's
    time, device included), while its twin's are not stretched (median
below 2x: the bookkeeping after the read adds to a short chunk)."""
    import time
    from repro_torch.cluster import replica_slowdown
    cfg = _smoke("tinyllama-1.1b", num_layers=2)
    eng = _fabric_engine(cuda, cfg)
    eng.apply_allocation(0.0, {"v": 2})
    eng.inject_fault(0.0, replica_slowdown(0.0, "v#0", 3.0))
    spans = {"v#0": [], "v#1": []}
    for rid, b in eng.backends.items():
        commit = b.commit_exec

        def timed(pending, now, b=b, rid=rid, commit=commit):
            out = commit(pending, now)
            if pending is not None and pending.kind == "decode":
                spans[rid].append((time.perf_counter()
                                   - pending.dispatched_at) * 1e3
                                  / max(b.commit_gap_ms
                                        + b.commit_wait_ms, 1e-6))
            return out
        b.commit_exec = timed
    for r in _fabric_requests(cfg.vocab_size, 12, time.time()):
        eng.submit(r, "v")
    eng.drain(0.0)
    assert len(eng.done) == 12
    assert spans["v#0"] and spans["v#1"]
    assert min(spans["v#0"]) >= 2.5, spans
    assert float(np.median(spans["v#1"])) < 2.0, spans


# ------------------------------------------------- the paper's controllers
EVAL_PROFILE = {     # rung -> (th_slope req/s a unit, p99 base ms, k ms)
    2: (9.0, 40.0, 160.0), 4: (6.0, 60.0, 240.0), 6: (4.0, 90.0, 330.0)}


def _eval_controller(kind, profiles):
    from repro_torch.core.adapter import (ControllerConfig,
                                          InfAdapterController,
                                          MSPlusController, VPAPlusController)
    from repro_torch.core.cocktail import CocktailController
    from repro_torch.core.forecaster import MovingMaxForecaster
    from repro_torch.core.infaas import INFaaSController
    cfg = ControllerConfig(interval_s=1.0, budget=12, slo_ms=2000.0,
                           beta=0.05, gamma=0.05, reactive=True,
                           queue_aware=True)
    fc = MovingMaxForecaster(window=10)
    return {"infadapter": lambda: InfAdapterController(profiles, fc, cfg),
            "ms+": lambda: MSPlusController(profiles, fc, cfg),
            "vpa+": lambda: VPAPlusController(profiles["L6"], cfg),
            "infaas": lambda: INFaaSController(profiles, cfg,
                                               min_accuracy=70.0),
            "cocktail": lambda: CocktailController(profiles, fc, cfg)}[kind]()


@pytest.mark.parametrize("kind", ["infadapter", "ms+", "vpa+", "infaas",
                                  "cocktail"])
def test_controller_drives_the_engine_on_the_card(cuda, kind):
    """Each of the paper's five controllers drives a three-rung ladder
    (d_model 128, 2/4/6 layers, kernels on, steps replayed) through
    ``run_serving_loop`` for a few seconds: requests are served with their
    full budget, each submission completes once or is counted as rejected,
    flash_prefill and flash_decode launch, and Cocktail's requests land
    only on its ensemble's members, one member each."""
    from repro_torch.core.profiles import VariantProfile
    from repro_torch.serving.driver import rise_fall_load, run_serving_loop
    from repro_torch.serving.engine import InProcessServingEngine
    variants = {f"L{n}": (_smoke("tinyllama-1.1b", num_layers=n), 70.0 + n)
                for n in EVAL_PROFILE}
    profiles = {f"L{n}": VariantProfile(
        name=f"L{n}", accuracy=70.0 + n, rt=0.5, th_slope=th,
        th_intercept=0.0, lat_base_ms=lb, lat_k_ms=lk, max_units=4)
        for n, (th, lb, lk) in EVAL_PROFILE.items()}
    eng = InProcessServingEngine(variants, max_batch=4, prompt_len=32,
                                 max_new=8, decode_chunk=4, use_kernels=True,
                                 device=cuda)
    ctrl = _eval_controller(kind, profiles)
    ops.reset_launch_counts()
    n = run_serving_loop(eng, ctrl, seconds=4.0, interval=1.0,
                         load_fn=rise_fall_load(4.0, 4.0, 16.0),
                         prompt_len=32, max_new=8, vocab=128, slo_ms=2000.0,
                         log=None)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert len(eng.done) > 0 and len(ctrl.decisions) >= 3
    rids = [r.rid for r in eng.done]
    assert len(rids) == len(set(rids))
    assert len(rids) + eng.rejected == n
    assert all(len(r.output) == 8 for r in eng.done)
    assert launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
    if kind == "cocktail":
        ensembles = [d.allocation.active_variants() for d in ctrl.decisions]
        assert max(map(len, ensembles)) > 1
        assert {r.backend for r in eng.done} <= set().union(*ensembles)
    eng.apply_allocation(0.0, {})
    assert not eng.backends


# ---------------------------------------------------------------------------
# the training path (A10, A11): plain tensor code under autograd on the
# card, held to the same step on the CPU; the kernels refuse autograd
# ---------------------------------------------------------------------------

def _train_cfg(**kw):
    """tinyllama's smoke variant (fp32, 2 layers, d_model 256, vocab
    512) with ``kw``."""
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config("tinyllama-1.1b")).replace(**kw)


def _train_state(cfg, device, seed=0):
    """fp32 params (the param dtype) drawn on the CPU, and a fresh Adam
    state, on ``device``."""
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import adam_init, tree_map
    params = LM(cfg).init(torch.Generator().manual_seed(seed),
                          dtype=torch.float32)
    params = tree_map(lambda t: t.to(device), params)
    return params, adam_init(params)


def _token_batches(cfg, n, B, S, device, seed=0):
    from repro_torch.data.tokens import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab_size, seq_len=S, batch=B,
                                  seed=seed, device=device)
    return [pipe.next_batch() for _ in range(n)]


# Adam's first update moves each element by at most ~lr (3e-6 at
# TRAIN_ADAM's first step): params of the two devices within 1e-5
TRAIN_PARAM_ATOL = 1e-5
TRAIN_LOSS_RTOL = 1e-5


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """Two ``make_train_step`` steps in fp32 (TF32 off) on the card and on
    the CPU from one state on the same batches: loss and ``grad_norm``
    within 1e-5 relative, params and moments within 1e-5 absolute."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = _train_cfg()
    step = make_train_step(cfg)
    runs = {}
    for dev in ("cpu", cuda):
        params, opt = _train_state(cfg, dev)
        out = []
        for batch in _token_batches(cfg, 2, 4, 64, dev):
            params, opt, m = step(params, opt, batch)
            out.append({k: float(v) for k, v in m.items()})
        runs[str(dev)] = (out, [t.cpu() for t in tree_leaves((params, opt))])
    (m_cpu, t_cpu), (m_card, t_card) = runs["cpu"], runs["cuda"]
    for a, b in zip(m_cpu, m_card):
        for k in ("loss", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=TRAIN_LOSS_RTOL), k
    for a, b in zip(t_cpu, t_card):
        assert float((a.float() - b.float()).abs().max()) <= TRAIN_PARAM_ATOL


def test_microbatched_train_step_on_the_card(cuda):
    """``microbatches=2`` against 1 on the card: params within 1e-5, loss
    within 1e-4 (the reference test's bounds)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = _train_cfg()
    params, opt = _train_state(cfg, cuda)
    batch = _token_batches(cfg, 1, 8, 64, cuda)[0]
    p1, _, m1 = make_train_step(cfg, microbatches=1)(params, opt, batch)
    p2, _, m2 = make_train_step(cfg, microbatches=2)(params, opt, batch)
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < 1e-5
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4


def test_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """bf16 compute on fp32 params with remat: three steps straight, and
    two steps, a checkpoint, a restore into a fresh state and the third
    step; the params and the Adam state are bitwise the same."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import tree_leaves
    cfg = _train_cfg(dtype="bfloat16", remat=True)
    step = make_train_step(cfg)
    batches = _token_batches(cfg, 3, 4, 64, cuda)
    params, opt = _train_state(cfg, cuda)
    for i, batch in enumerate(batches):
        params, opt, _ = step(params, opt, batch)
        if i == 1:
            ckpt.save(str(tmp_path), i, {"params": params, "opt": opt})
    fresh_p, fresh_o = _train_state(cfg, cuda, seed=9)
    state, _ = ckpt.restore(str(tmp_path), {"params": fresh_p,
                                            "opt": fresh_o})
    p2, o2, _ = step(state["params"], state["opt"], batches[2])
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remat_on_the_card_equals_off_and_takes_less_memory(cuda):
    """tinyllama at full width and 4 layers, bf16 compute, B 4 x 512: the
    checkpointed layers give the same loss and gradients, bitwise, and a
    lower peak of ``max_memory_allocated`` over the loss and backward."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import tree_leaves, value_and_grad
    base = get_config("tinyllama-1.1b").replace(num_layers=4)
    params, _ = _train_state(base, cuda)
    batch = _token_batches(base, 1, 4, 512, cuda)[0]
    out = {}
    for remat in (False, True):
        lm = LM(base.replace(remat=remat))
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = value_and_grad(lm.loss, params, batch)
        torch.cuda.synchronize()
        out[remat] = (loss, tree_leaves(grads),
                      torch.cuda.max_memory_allocated() - start)
        del grads
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    assert out[True][2] < out[False][2]


def test_lstm_training_on_the_card_equals_the_cpu(cuda):
    """The paper's LSTM trained as ``launch.train_forecaster`` does (the
    4 h trace of seed 2, 75% split, batch 64) on both devices: one seed,
    one set of initial params and the same numpy batch indices; the first
    20 losses within 1e-4 relative (fp32 sums in other orders over 600
    recurrent steps)."""
    from repro_torch.core import forecaster as pf
    from repro_torch.data.traces import synthetic_twitter_trace
    trace = synthetic_twitter_trace(seconds=4 * 3600, seed=2)
    train = trace[:int(len(trace) * 0.75)]
    _, cpu = pf.train_lstm_forecaster(train, steps=20, device="cpu")
    fc, card = pf.train_lstm_forecaster(train, steps=20, device=cuda)
    np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=0)
    assert fc.params["wh"].is_cuda and fc.predict(trace[:3600]) >= 0.0


def test_training_with_kernels_on_the_card_raises(cuda):
    """``use_kernels=True`` on the card: ``LM.loss(...).backward()`` raises
    at the first attention kernel instead of leaving the gradients of
    ``wq``, ``wk`` and ``wv`` empty; without grad the same forward runs
    the kernels."""
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    cfg = _train_cfg(use_kernels=True)
    params, _ = _train_state(cfg, cuda)
    batch = _token_batches(cfg, 1, 2, 64, cuda)[0]
    live = tree_unflatten(params, [p.detach().requires_grad_()
                                   for p in tree_leaves(params)])
    lm = LM(cfg)
    with pytest.raises(RuntimeError, match="no backward"):
        loss, _ = lm.loss(live, batch)
        loss.backward()
    assert all(p.grad is None for p in tree_leaves(live))
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _ = lm.apply(live, batch)
    assert ops.launch_counts()["flash_prefill"] == cfg.num_layers
    assert bool(torch.isfinite(logits).all())


def _entry_point_calls(dev, grad=False):
    """Each ``ops`` entry point with small float inputs on ``dev``, those
    inputs requiring grad with ``grad``."""
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).requires_grad_(grad)

    tables = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    return {
        "flash_prefill": lambda: ops.flash_prefill(
            r(1, 16, 4, 64), r(1, 16, 2, 64), r(1, 16, 2, 64)),
        "flash_decode": lambda: ops.flash_decode(
            r(1, 1, 4, 64), r(1, 16, 2, 64), r(1, 16, 2, 64),
            torch.zeros(1, 16, device=dev)),
        "flash_decode_bkchd": lambda: ops.flash_decode_bkchd(
            r(1, 2, 2, 64), r(1, 2, 16, 64), r(1, 2, 16, 64),
            torch.zeros(1, 16, device=dev)),
        "flash_decode_chunk": lambda: ops.flash_decode_chunk(
            r(1, 3, 2, 2, 64), r(1, 2, 16, 64), r(1, 2, 16, 64),
            torch.zeros(1, 3, 16, device=dev)),
        "paged_flash_decode": lambda: ops.paged_flash_decode(
            r(1, 2, 2, 64), r(2, 4, 16, 64), r(2, 4, 16, 64), tables,
            torch.tensor([20], dtype=torch.int32, device=dev)),
        "paged_flash_decode_chunk": lambda: ops.paged_flash_decode_chunk(
            r(1, 3, 2, 2, 64), r(2, 4, 16, 64), r(2, 4, 16, 64), tables,
            torch.tensor([[18, 19, 20]], dtype=torch.int32, device=dev)),
        "ssd_scan": lambda: ops.ssd_scan(
            r(1, 16, 2, 32), torch.rand((1, 16, 2), generator=g, device=dev),
            -torch.rand((2,), generator=g, device=dev), r(1, 16, 16),
            r(1, 16, 16), chunk=8),
    }


@pytest.mark.parametrize("name", list(_entry_point_calls("cpu")))
def test_kernel_entry_points_refuse_autograd_on_the_card(cuda, name):
    """Every entry point raises on the card when grad mode is on and an
    input requires grad, and launches as before under ``no_grad`` or when
    no input requires grad."""
    with_grad = _entry_point_calls(cuda, grad=True)[name]
    with pytest.raises(RuntimeError, match="no backward"):
        with_grad()
    with torch.no_grad():
        out = with_grad()
    first = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(first).all()) and not first.requires_grad
    _entry_point_calls(cuda)[name]()         # inputs without grad: runs


# ------------------------------------------------ whisper-tiny, internvl2-26b
def _multimodal_batch(cfg, B, S, seed, device):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.num_frontend_tokens, 1024), generator=gen)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((B, cfg.enc_seq, 80), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch,layers", [("whisper-tiny", None),
                                         ("internvl2-26b", 2)])
def test_multimodal_model_on_the_card_equals_the_cpu(cuda, arch, layers):
    """whisper-tiny at its published size (4 + 4 layers, 1500 frames) and
    internvl2-26b at full width cut to 2 layers (256 image tokens), fp32,
    kernels on: a prefill of 32 tokens and 4 decode steps on the card
    against the same calls on the CPU (plain paths) on the same weights,
    logits within 1e-3 of their largest magnitude (fp32 sums in other
    orders over 1500 frames or d_model 6144), greedy tokens equal;
    launches one per layer a prefill and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = get_config(arch).replace(dtype="float32", use_kernels=True)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    L = cfg.num_layers
    card = LM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = _tree_to(card, "cpu")
    batch = _multimodal_batch(cfg, 2, 32, 3, "cpu")
    S = 32 + (cfg.num_frontend_tokens if cfg.frontend else 0)
    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        lm = LM(cfg)
        b = {k: v.to(dev) for k, v in batch.items()}
        n0 = ops.launch_counts()
        lg, cache = lm.prefill(params, b, max_len=S + 4)
        seq, logits = [], [lg]
        for _ in range(4):
            tok = torch.argmax(lg, -1)
            seq.append(tok.cpu())
            lg, cache = lm.decode_step(params, cache, tok)
            logits.append(lg)
        n1 = ops.launch_counts()
        outs[dev] = (seq, [x.cpu() for x in logits],
                     {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]})
    assert outs["cuda"][2] == {"flash_prefill": L, "flash_decode": 4 * L}
    assert outs["cpu"][2] == {}
    for a, b in zip(outs["cuda"][0], outs["cpu"][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs["cuda"][1], outs["cpu"][1]):
        scale = float(b[..., :cfg.vocab_size].abs().max())
        assert float((a - b)[..., :cfg.vocab_size].abs().max()) <= \
            1e-3 * scale


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_whisper_encoder_runs_no_kernel(cuda):
    """The encoder is plain tensor code (the reference reaches no Pallas
    kernel there): encoding 1500 frames with the kernels on launches none."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = get_config("whisper-tiny").replace(use_kernels=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0))
    frames = torch.randn((2, 1500, 80), device=cuda)
    n0 = ops.launch_counts()
    enc = lm.encode(params, frames)
    torch.cuda.synchronize()
    assert ops.launch_counts() == n0
    assert enc.shape == (2, 1500, 384) and bool(torch.isfinite(enc).all())


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet152"])
def test_apply_resnet_on_the_card_equals_the_cpu(cuda, name):
    """fp32 with TF32 off, B 2 at 224 x 224: the card's cuDNN convolutions
    against the CPU's within 1e-5 of the logits' largest magnitude."""
    from repro_torch.models import resnet
    params = resnet.init_resnet(torch.Generator().manual_seed(0), name)
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator()
                    .manual_seed(1))
    want = resnet.apply_resnet(params, name, x)
    got = resnet.apply_resnet(_tree_to(params, cuda), name, x.to(cuda))
    assert got.shape == (2, 1000)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("kv", [{}, dict(kv_cache="paged", kv_page_size=16,
                                         kv_prefix_sharing=True)],
                         ids=["dense", "paged"])
def test_internvl_engine_close_returns_memory(cuda, kv):
    """internvl2-26b at full width cut to 1 and 2 layers (3.5 GB of bf16
    weights, the untied 92553-row embedding and unembedding among them),
    text-only requests: after ``apply_allocation(t, {})`` and a collection,
    ``memory_allocated`` is back at the engine's start within 0.1 GB."""
    import gc
    import time
    from repro_torch.configs import get_config
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine
    from repro_torch.serving.graphs import tensor_leaves
    base = get_config("internvl2-26b")
    variants = {f"L{n}": (base.replace(num_layers=n, name=f"L{n}"), 70.0)
                for n in (1, 2)}
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    eng = InProcessServingEngine(variants, max_batch=4, prompt_len=64,
                                 max_new=8, decode_chunk=2, use_kernels=True,
                                 device=cuda, **kv)
    eng.apply_allocation(0.0, {n: 1 for n in variants})
    own = sum(t.numel() * t.element_size() for b in eng.backends.values()
              for t in tensor_leaves(b.params) + tensor_leaves(b.cache))
    rng = np.random.default_rng(4)
    for i in range(8):
        eng.submit(Request(rid=i, tokens=rng.integers(0, base.vocab_size, 64),
                           max_new=8, arrival=time.time()),
                   f"L{1 + i % 2}")
    eng.drain(0.0)
    eng.apply_allocation(0.0, {})
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - start
    assert own > 3e9 and len(eng.done) == 8
    assert all(len(r.output) == 8 for r in eng.done)
    assert left <= 0.1e9, (left, own)

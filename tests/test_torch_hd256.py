"""The attention kernels' plain versions at gemma-2b's head dim 256 (and
flash_prefill's hd 32) against the reference, their CUDA launch plans at
gemma's serve shapes, and the plain path's q-block prefill.

The reference runs its Pallas kernels in interpret mode (as its own kernel
tests do on the CPU) and its ``kernels/ref.py`` oracles, at the shapes of
its kernel tests ((1, 96, 8, 8, 256), (2, 128, 4, 4, 32) with a window of
32, (2, 96, 8, 8, 256) for decode) and at gemma's MQA group of 8 over one
KV head. Tolerances: fp32 1e-5 absolute (sums in other orders); bf16 3e-2,
the reference kernel tests' own (each side rounds an fp32 result to bf16).
The launch plans are CPU functions (``check_args``, ``launch_plan``,
``smem_bytes``): the kernels themselves are held to these plain versions on
the card (``tests/test_torch_cuda.py``, chip_smoke's dense-config phase).
``flash_attend_qblocks`` is held to the reference's at a small block, and
``attention_forward`` with the kernels off to the reference's at S = 2100,
where both take the q-block branch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as ja
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import attention as pa

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
GEMMA_G, GEMMA_HD = 8, 256          # gemma-2b: 8 query heads on 1 KV head


def _np(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _both(arrays, dtype):
    """(port tensors, reference arrays) of the same numbers in ``dtype``."""
    return ([torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a, dtype) for a in arrays])


def _close(got, wants, dtype):
    for want in wants:
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dtype])


# ------------------------------------------------------------ flash_prefill
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window,softcap", [
    (1, 96, 8, 8, 256, 0, 0.0),       # the reference test's hd 256
    (2, 128, 4, 4, 32, 32, 0.0),      # the reference test's hd 32, window
    (1, 80, 8, 1, 256, 0, 0.0),       # gemma-2b's MQA group of 8
    (2, 40, 8, 1, 256, 16, 30.0),     # gemma's heads, window, softcap
    (2, 50, 4, 2, 32, 0, 30.0),       # hd 32, softcap, ragged S
])
def test_plain_prefill_matches_pallas_and_oracle(B, S, H, KV, hd, window,
                                                 softcap, dtype):
    rng = np.random.default_rng(S + hd)
    (q, k, v), (jq, jk, jv) = _both(
        [_np(rng, B, S, H, hd), _np(rng, B, S, KV, hd),
         _np(rng, B, S, KV, hd)], dtype)
    got = fp.flash_prefill_bshd(q, k, v, window=window, softcap=softcap)
    _close(got, [jops.flash_prefill(jq, jk, jv, window=window,
                                    softcap=softcap),
                 jref.ref_flash_prefill(jq, jk, jv, window=window,
                                        softcap=softcap)], dtype)


# ------------------------------------------------------------- flash_decode
def _decode_np(rng, B, KV, G, hd, C):
    bias = np.where(rng.random((B, C)) < 0.8, 0.0, -1e9).astype(np.float32)
    bias[:, 0] = 0.0
    return (_np(rng, B, KV, G, hd), _np(rng, B, KV, C, hd),
            _np(rng, B, KV, C, hd), bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,C,softcap", [
    (2, 8, 1, 96, 0.0),               # the reference test's (2, 96, 8, 8)
    (2, 1, GEMMA_G, 100, 0.0),        # gemma's decode step
    (3, 1, GEMMA_G, 576, 30.0),       # gemma at the serve ring, softcap
])
def test_plain_decode_matches_pallas_and_oracle(B, KV, G, C, softcap, dtype):
    q, k, v, bias = _decode_np(np.random.default_rng(C), B, KV, G, GEMMA_HD,
                               C)
    (tq, tk, tv), (jq, jk, jv) = _both([q, k, v], dtype)
    got = fd.flash_decode_bkhd(tq, tk, tv, torch.as_tensor(bias),
                               softcap=softcap)
    pallas = jops.flash_decode_bkchd(jq, jk, jv, jnp.asarray(bias),
                                     softcap=softcap)
    oracle = jref.ref_flash_decode(
        jq.reshape(B, 1, KV * G, GEMMA_HD), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), jnp.asarray(bias), softcap=softcap)
    _close(got, [pallas], dtype)
    _close(got.reshape(B, 1, KV * G, GEMMA_HD), [oracle], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_chunk_matches_per_token_pallas(dtype):
    """The chunk form at gemma's heads (ck 5 at ragged starts) against one
    reference Pallas call per chunk token, as the reference's dense prefill
    continuation makes them."""
    rng = np.random.default_rng(7)
    B, ck, C = 3, 5, 40
    q = _np(rng, B, ck, 1, GEMMA_G, GEMMA_HD)
    k, v = _np(rng, B, 1, C, GEMMA_HD), _np(rng, B, 1, C, GEMMA_HD)
    start = np.array([0, 17, C - 3])
    pos = start[:, None] + np.arange(ck)[None, :]
    bias = np.where(np.arange(C)[None, None, :] <= pos[:, :, None], 0.0,
                    -1e9).astype(np.float32)
    (tq, tk, tv), (jq, jk, jv) = _both([q, k, v], dtype)
    got = fd.flash_decode_chunk(tq, tk, tv, torch.as_tensor(bias))
    want = jnp.stack([jops.flash_decode_bkchd(jq[:, j], jk, jv,
                                              jnp.asarray(bias[:, j]))
                      for j in range(ck)], axis=1)
    _close(got, [want], dtype)


# ------------------------------------------------------------- paged_decode
def _paged_np(rng, B, KV, G, ps, width):
    P = B * width + 1
    tables = rng.permutation(np.arange(1, P)).reshape(B, width)
    lengths = rng.integers(1, width * ps + 1, B)
    lengths[1] = 0                                  # a dead row
    return (_np(rng, B, KV, G, GEMMA_HD), _np(rng, KV, P, ps, GEMMA_HD),
            _np(rng, KV, P, ps, GEMMA_HD), tables.astype(np.int32),
            lengths.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("KV,G,ps,softcap", [(1, GEMMA_G, 16, 0.0),
                                             (1, GEMMA_G, 8, 30.0),
                                             (4, 1, 16, 0.0)])
def test_plain_paged_decode_matches_pallas_and_oracle(KV, G, ps, softcap,
                                                      dtype):
    q, kp, vp, tables, lengths = _paged_np(np.random.default_rng(ps), 3, KV,
                                           G, ps, 4)
    (tq, tk, tv), (jq, jk, jv) = _both([q, kp, vp], dtype)
    got = pd.paged_flash_decode_bkhd(tq, tk, tv, torch.as_tensor(tables),
                                     torch.as_tensor(lengths),
                                     softcap=softcap)
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    _close(got, [jops.paged_flash_decode(jq, jk, jv, jt, jl, softcap=softcap),
                 jref.ref_paged_decode(jq, jk, jv, jt, jl, softcap=softcap)],
           dtype)
    assert not to_np(got)[1].any()                  # length 0 -> zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_paged_chunk_matches_per_token_pallas(dtype):
    rng = np.random.default_rng(9)
    B, ck, ps, width = 3, 4, 16, 4
    q1, kp, vp, tables, _ = _paged_np(rng, B, 1, GEMMA_G, ps, width)
    q = _np(rng, B, ck, 1, GEMMA_G, GEMMA_HD)
    lengths = np.clip(np.array([[5], [0], [60]]) + np.arange(ck), 0,
                      width * ps).astype(np.int32)
    (tq, tk, tv), (jq, jk, jv) = _both([q, kp, vp], dtype)
    got = pd.paged_flash_decode_chunk(tq, tk, tv, torch.as_tensor(tables),
                                      torch.as_tensor(lengths))
    want = jnp.stack([jops.paged_flash_decode(
        jq[:, j], jk, jv, jnp.asarray(tables), jnp.asarray(lengths[:, j]))
        for j in range(ck)], axis=1)
    _close(got, [want], dtype)


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plans_at_gemmas_serve_shapes(dtype):
    """The CUDA wrappers' checks pass at gemma-2b's serve shapes (B 8, S
    512, 8 heads on one KV head, hd 256; the ring C 576; the fused tick's
    ck 16; pages of 16) with every block's shared memory within one H100
    block: 64-position K/V tiles in bf16, 32 in fp32. The chunk forms run
    on the tensor cores in bf16 (64 query rows a CTA) and on the CUDA cores
    in fp32 (16 rows); so do both decode steps, in bf16 on their own
    tensor-core kernels (16 rows, ``STEP_SPLITS[256]`` CTAs per (b,
    kv-head), one cluster), in fp32 on the CUDA-core ones (their G
    rows, ``SPLITS``); flash_prefill in bf16 on its two-head ``wgmma``
    kernel."""
    es = torch.tensor([], dtype=dtype).element_size()
    z = lambda *s: torch.zeros(s, dtype=dtype)            # noqa: E731
    fp.check_args(z(8, 512, 8, 256), z(8, 512, 1, 256), z(8, 512, 1, 256), 0)
    fp.check_args(z(2, 128, 4, 32), z(2, 128, 4, 32), z(2, 128, 4, 32), 32)
    assert fd.tile_rows(256, es) == (64 if es == 2 else 32)
    assert fd.tile_rows(64, es) == (128 if es == 2 else 64)
    bf = dtype == torch.bfloat16
    assert fp.smem_bytes(256, dtype) <= fp.MAX_SMEM_BYTES
    assert fp.launch_plan(256, dtype)[0] == (
        "flash_prefill_wide_kernel" if bf else "flash_prefill_simt_kernel")
    k = z(8, 1, 576, 256)
    assert fd.check_args(z(8, 1, 8, 256), k, k, torch.zeros(8, 576),
                         False) == ((1, True, fd.STEP_ROWS,
                                     fd.STEP_SPLITS[256])
                                    if bf else (1, False, 8, fd.SPLITS))
    assert fd.STEP_SPLITS[256] <= 8     # a (b, kv-head)'s splits: a cluster
    assert fd.STEP_SMEM_BYTES[256] <= fd.MAX_SMEM_BYTES // 2  # two an SM
    assert fd.check_args(z(8, 16, 1, 8, 256), k, k, torch.zeros(8, 16, 576),
                         True) == ((16, True, 64, fd.TC_SPLITS) if bf
                                   else (16, False, 16, fd.SPLITS))
    assert fd.chunk_rows(16, 8, 256) == 16
    for rows in (8, 16):
        assert fd.smem_bytes(8, 256, es, rows) <= fd.MAX_SMEM_BYTES
        assert pd.simt_smem_bytes(rows, 256, es) <= pd.MAX_SMEM_BYTES
    assert fd.smem_bytes(8, 256, 2, 16) == 154_816    # 64-row tiles
    pool = z(1, 8 * 36 + 1, 16, 256)
    tables = torch.zeros((8, 36), dtype=torch.int32)
    assert pd.check_args(z(8, 1, 8, 256), pool, pool, tables,
                         torch.ones(8, dtype=torch.int32), False) == \
        ((1, True, pd.STEP_ROWS, pd.STEP_SPLITS[256]) if bf
         else (1, False, 8, pd.SPLITS))
    assert pd.check_args(z(8, 16, 1, 8, 256), pool, pool, tables,
                         torch.ones((8, 16), dtype=torch.int32), True) == \
        ((16, True, 64, pd.CHUNK_SPLITS) if bf
         else (16, False, 16, pd.CHUNK_SPLITS))
    assert fd.TC_SMEM_BYTES[256] <= fd.MAX_SMEM_BYTES
    assert pd.TC_SMEM_BYTES[256] <= pd.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shapes_out_of_the_domain_still_raise(dtype):
    """hd 512 (and a prefill head dim with no instance) raise in the
    checks, before any launch: both chunk forms have no tensor-core
    instance there, and the CUDA-core block exceeds one H100 block."""
    z = lambda *s: torch.zeros(s, dtype=dtype)            # noqa: E731
    for hd in (48, 512):
        with pytest.raises(ValueError, match="hd in"):
            fp.check_args(z(1, 8, 8, hd), z(1, 8, 1, hd), z(1, 8, 1, hd), 0)
    k = z(1, 1, 8, 512)
    with pytest.raises(ValueError, match="shared memory"):
        fd.check_args(z(1, 1, 8, 512), k, k, torch.zeros(1, 8), False)
    with pytest.raises(ValueError, match="shared memory"):
        fd.check_args(z(1, 2, 1, 8, 512), k, k, torch.zeros(1, 2, 8), True)
    pool = z(1, 3, 16, 512)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        pd.check_args(z(1, 1, 8, 512), pool, pool, tables,
                      torch.ones(1, dtype=torch.int32), False)
    with pytest.raises(ValueError, match="shared memory"):
        pd.check_args(z(1, 2, 1, 8, 512), pool, pool, tables,
                      torch.ones((1, 2), dtype=torch.int32), True)


@pytest.mark.parametrize("hd,G,dtype,want", [
    (256, 8, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (256, 1, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (256, 3, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (256, 7, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (256, 16, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (256, 8, torch.float32, (False, 8, "flash_decode_kernel")),
    (256, 3, torch.float32, (False, 3, "flash_decode_kernel")),
    (128, 8, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (128, 8, torch.float32, (False, 8, "flash_decode_kernel")),
    (64, 8, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (64, 3, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (64, 8, torch.float32, (False, 8, "flash_decode_kernel")),
    (128, 6, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (128, 16, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (128, 1, torch.bfloat16, (True, 16, "flash_decode_step_kernel")),
    (128, 6, torch.float32, (False, 6, "flash_decode_kernel")),
    (128, 17, torch.bfloat16, (False, 17, "flash_decode_kernel")),
])
def test_decode_step_plan_by_head_dim_and_dtype(hd, G, dtype, want):
    """The bf16 decode step at hd 64, 128 and 256 takes the tensor-core
    step kernel (any G up to its 16-row M, ``STEP_SPLITS[hd]`` CTAs per
    (b, kv-head)); fp32 and a group above 16 rows keep the CUDA-core
    kernel with their G rows and ``SPLITS``. ``check_args`` returns the
    plan, with the CTA's shared memory within one H100 block (two step
    CTAs an SM at hd 256, five at hd 128, four at hd 64 with its
    128-position tiles)."""
    tc, rows, kernel = want
    splits = fd.STEP_SPLITS[hd] if tc else fd.SPLITS
    assert fd.launch_plan(1, G, hd, dtype, False) == (tc, rows, splits)
    assert fd.KERNELS[tc, False][1] == kernel
    k = torch.zeros((2, 1, 40, hd), dtype=dtype)
    assert fd.check_args(torch.zeros((2, 1, G, hd), dtype=dtype), k, k,
                         torch.zeros((2, 40)), False) == (1, tc, rows, splits)
    if tc:
        tile = fd.STEP_TILE[hd]             # 128 positions at hd 64
        assert fd.STEP_SMEM_BYTES[hd] == 2 * (16 + 2 * tile) * (hd + 8) + 4 * (
            16 * (tile + 4) + 128) == {64: 48_128, 128: 44_032,
                                       256: 80_896}[hd]
        assert fd.MAX_SMEM_BYTES // fd.STEP_SMEM_BYTES[hd] == {
            64: 4, 128: 5, 256: 2}[hd]
        # the cluster combine's partial (16 rows of hd + 4 floats, m, l)
        # goes where the 64-position K tile was
        assert 4 * (fd.STEP_ROWS * (hd + 4) + 2 * fd.STEP_ROWS) <= \
            2 * 64 * (hd + 8)


def test_decode_step_above_the_step_route_still_raises():
    """At hd 256 a group wider than the step kernel's 16-row M leaves the
    bf16 decode step on the CUDA cores, whose 4096 accumulators a group
    cannot hold: refused before any launch, as before."""
    bf = torch.bfloat16
    assert fd.launch_plan(1, 17, 256, bf, False) == (False, 17, fd.SPLITS)
    k = torch.zeros((1, 1, 8, 256), dtype=bf)
    with pytest.raises(ValueError, match="G\\*hd"):
        fd.check_args(torch.zeros((1, 1, 17, 256), dtype=bf), k, k,
                      torch.zeros(1, 8), False)


PREFILL_PLANS = {
    # (hd, dtype) -> (kernel, threads, query heads a CTA, shared bytes)
    (32, "bfloat16"): ("flash_prefill_mma_kernel", 128, 1, 25_600),
    (64, "bfloat16"): ("flash_prefill_wide_kernel", 128, 1, 41_984),
    (128, "bfloat16"): ("flash_prefill_wide_kernel", 128, 1, 82_944),
    (256, "bfloat16"): ("flash_prefill_wide_kernel", 256, 2, 197_632),
    (32, "float32"): ("flash_prefill_simt_kernel", 128, 1, 40_960),
    (64, "float32"): ("flash_prefill_simt_kernel", 128, 1, 65_536),
    (128, "float32"): ("flash_prefill_simt_kernel", 128, 1, 114_688),
    (256, "float32"): ("flash_prefill_simt_kernel", 128, 1, 212_992),
}


@pytest.mark.parametrize("hd,dtype", sorted(PREFILL_PLANS))
def test_prefill_launch_plan_mirrors_the_dispatch(hd, dtype):
    """``launch_plan`` and ``smem_bytes`` of flash_prefill at every head dim
    it is built for, in both dtypes, as ``flash_prefill_launch``
    dispatches: every CTA within one H100 block (the bf16 pipelined route:
    at hd 64 and 128 Q of one head and two-tile K and V rings of 8 and 16
    KB tiles, at hd 256 Q of two heads and rings of 32 KB tiles, 1 KB of
    alignment), and ``check_args`` passes there."""
    dt = getattr(torch, dtype)
    kernel, threads, heads, smem = PREFILL_PLANS[hd, dtype]
    assert fp.launch_plan(hd, dt) == (kernel, threads, heads)
    assert fp.smem_bytes(hd, dt) == smem <= fp.MAX_SMEM_BYTES
    z = lambda *s: torch.zeros(s, dtype=dt)               # noqa: E731
    fp.check_args(z(2, 65, 8, hd), z(2, 65, 1, hd), z(2, 65, 1, hd), 0)


# (hd, dtype) -> CTAs an SM the plan counts on
PREFILL_CTAS = {(64, "bfloat16"): 4, (128, "bfloat16"): 2}


@pytest.mark.parametrize("hd,dtype", sorted(PREFILL_PLANS))
def test_prefill_smem_fits_the_ctas_an_sm_the_plan_assumes(hd, dtype):
    """The CTAs an SM that flash_prefill's launch bounds ask for (four
    one-head CTAs of the pipelined kernel at hd 64, two at hd 128) fit one
    H100 SM: their shared memory, with the 1 KB the card reserves for each
    CTA, and their threads."""
    dt = getattr(torch, dtype)
    ctas = fp.ctas_per_sm(hd, dt)
    assert ctas == PREFILL_CTAS.get((hd, dtype), 1)
    assert ctas * (fp.smem_bytes(hd, dt) + 1024) <= fp.SM_SMEM_BYTES
    assert ctas * fp.launch_plan(hd, dt)[1] <= fp.SM_THREADS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 48, 512])
def test_prefill_head_dims_without_an_instance_are_refused(hd, dtype):
    """A head dim flash_prefill has no instance for (hd 512 among them)
    raises in ``check_args``, before any launch."""
    z = lambda *s: torch.zeros(s, dtype=dtype)            # noqa: E731
    with pytest.raises(ValueError, match="hd in"):
        fp.check_args(z(1, 8, 8, hd), z(1, 8, 1, hd), z(1, 8, 1, hd), 0)


# ---------------------------------------------------------- q-block prefill
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 30.0),
                                            (9, 30.0)])
@pytest.mark.parametrize("S", [16, 37])                 # 37: a short block
def test_flash_attend_qblocks_matches_reference(S, window, softcap):
    rng = np.random.default_rng(S + window)
    q, k, v = _np(rng, 2, S, 4, 32), _np(rng, 2, S, 2, 32), \
        _np(rng, 2, S, 2, 32)
    got = pa.flash_attend_qblocks(*map(torch.as_tensor, (q, k, v)), window,
                                  softcap, bq=8)
    want = ja.flash_attend_qblocks(*map(jnp.asarray, (q, k, v)), window,
                                   softcap, bq=8)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
    full = pa.gqa_attend(*map(torch.as_tensor, (q, k, v)),
                         pa.causal_mask_bias(S, S, 0, window), softcap)
    torch.testing.assert_close(got, full, atol=1e-5, rtol=0)


def test_attention_forward_above_the_threshold_matches_reference(
        monkeypatch):
    """With the kernels off and S = 2100 > ``FLASH_JNP_THRESHOLD``, both
    packages take the q-block branch (the port's is spied on) and agree."""
    assert pa.FLASH_JNP_THRESHOLD == ja.FLASH_JNP_THRESHOLD == 2048
    assert pa.FLASH_JNP_BQ == ja.FLASH_JNP_BQ
    from repro.configs.base import ModelConfig as JConfig
    fields = dict(name="qblock", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                  vocab_size=64, dtype="float32")
    jcfg, pcfg = JConfig(**fields), ModelConfig(**fields)
    rng = np.random.default_rng(0)
    S = 2100
    w = {n: _np(rng, *s) * 0.2 for n, s in (
        ("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
        ("wo", (32, 32)))}
    x = _np(rng, 1, S, 32)
    calls = []
    real = pa.flash_attend_qblocks
    monkeypatch.setattr(pa, "flash_attend_qblocks",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = pa.attention_forward(pcfg, {n: torch.as_tensor(a)
                                      for n, a in w.items()},
                               torch.as_tensor(x),
                               torch.arange(S)[None])
    want = ja.attention_forward(jcfg, {n: jnp.asarray(a)
                                       for n, a in w.items()},
                                jnp.asarray(x), jnp.arange(S)[None])
    assert calls == [1]
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)

"""The dense prefill continuation against the reference on the CPU.

``flash_decode_chunk`` gives ck query tokens per row a bias row each and is
defined as the single-query flash decode at each token's bias row,
stacked: the reference's own per-token loop in
``repro/models/attention.py:chunk_prefill_attention``. Here its plain
version (what the wrapper runs on CPU tensors) is held to the reference's
Pallas ``flash_decode_bkchd`` (interpret mode) called once per chunk token
and to its oracle ``_chunk_attend``; the port's ``chunk_prefill_attention``
and ``LM.prefill_chunk`` are held to the reference's with the kernels off
and on, every cache leaf included (positions that padded queries and inert
rows must not touch are compared exactly); the launch plan and refusals of
the CUDA wrapper are checked without a card. Inputs come from a numpy seed.
Tolerances: fp32 1e-5 absolute (both sides accumulate in fp32, in
different orders), bf16 3e-2 (each rounds an fp32 result to bf16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params, np_tree, port_config, to_np
from conftest import tiny_variants
from repro.kernels import ops as jops
from repro.models import attention as ja
from repro.models.model import build_model
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import attention as pa
from repro_torch.models.model import LM

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _chunk_np(rng, ck, G, B=4, KV=2, hd=64, C=40):
    """q (B, ck, KV, G, hd), k/v (B, KV, C, hd) and the causal bias
    (B, ck, C) of chunks at ragged starts: row 0 crossing the middle of the
    cache, row 1 at 0, row 2 running past C (its late queries see the whole
    cache), row 3 an inert row at 0 (all its queries still see key 0)."""
    q = rng.standard_normal((B, ck, KV, G, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    start = np.array([C // 2 - 1, 0, C - ck // 2 - 1, 0])[:B]
    pos = start[:, None] + np.arange(ck)[None, :]
    bias = np.where(np.arange(C)[None, None, :] <= pos[:, :, None], 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("ck", [1, 4, 16])
def test_chunk_plain_matches_per_token_pallas_and_oracle(ck, G, softcap,
                                                         dtype):
    q, k, v, bias = _chunk_np(np.random.default_rng(ck * G), ck, G)
    tdt = getattr(torch, dtype)
    got = to_np(fd.flash_decode_chunk_plain(
        *(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
        torch.as_tensor(bias), softcap=softcap))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    pallas = np.stack([np.asarray(jops.flash_decode_bkchd(
        jq[:, j], jk, jv, jnp.asarray(bias[:, j]), softcap=softcap),
        np.float32) for j in range(ck)], axis=1)
    np.testing.assert_allclose(got, pallas, atol=ATOL[dtype])
    if dtype != "float32":       # the jnp oracle's bf16 dot has no CPU form
        return
    B, _, KV, _, hd = q.shape
    cfg = tiny_variants(1)["small"][0].replace(attn_logit_softcap=softcap)
    oracle = ja._chunk_attend(cfg, jq.reshape(B, ck, KV * G, hd), jk, jv,
                              jnp.asarray(bias))
    np.testing.assert_allclose(
        got, np.asarray(oracle, np.float32).reshape(got.shape),
        atol=ATOL[dtype])


def test_only_the_first_key_unmasked():
    """Queries whose bias masks all but key 0 return v[0] exactly."""
    rng = np.random.default_rng(7)
    q, k, v, _ = _chunk_np(rng, 3, 4)
    bias = np.full((4, 3, 40), -1e9, np.float32)
    bias[..., 0] = 0.0
    got = fd.flash_decode_chunk_plain(*(torch.as_tensor(a)
                                        for a in (q, k, v, bias)))
    want = torch.as_tensor(v)[:, :, 0][:, None, :, None, :].expand_as(got)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_chunk_wrapper_on_cpu_is_the_plain_version():
    """``ops.flash_decode_chunk`` meets the operand rules (a strided q, a
    bias of another float dtype) and on CPU tensors gives the stack of
    ``ops.flash_decode_bkchd`` calls, launching nothing."""
    q, k, v, bias = (torch.as_tensor(a) for a in _chunk_np(
        np.random.default_rng(3), 16, 8))
    qs = q.transpose(2, 3).contiguous().transpose(2, 3)     # strided view
    n0 = dict(ops.launch_counts())
    got = ops.flash_decode_chunk(qs, k, v, bias.double(), softcap=30.0)
    want = torch.stack([ops.flash_decode_bkchd(q[:, j], k, v, bias[:, j],
                                               softcap=30.0)
                        for j in range(q.shape[1])], dim=1)
    assert ops.launch_counts() == n0
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


# --------------------------------------------------------------- attention
def _cfgs(kv, softcap, pallas):
    from repro.configs import get_config, smoke_variant
    jc = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=128, num_heads=8, num_kv_heads=kv, head_dim=64,
        attn_logit_softcap=softcap, use_pallas=pallas)
    jp = ja.init_attention(jax.random.PRNGKey(1), jc)
    return jc, port_config(jc), jp, {k: torch.as_tensor(v)
                                     for k, v in np_tree(jp).items()}


@pytest.mark.parametrize("ck,C", [(16, 48), (16, 12)])
@pytest.mark.parametrize("kv,softcap,pallas", [
    (1, 0.0, False), (2, 30.0, False), (2, 0.0, True), (4, 30.0, True)])
def test_chunk_prefill_attention_matches_reference(kv, softcap, pallas, ck,
                                                   C):
    """A 16-token chunk at GQA group 8, 4 or 2 (with the kernels on, the
    port's single chunk launch — here its plain version — against the
    reference's 16 Pallas calls) over rows that start mid-cache, at 0,
    end at the cache's last slot (its padded tokens past C) and sit inert;
    at C = 12 the chunk is longer than the cache. Outputs of the valid
    tokens agree, and so does every cache entry: written slots to the
    tolerance, every other slot exactly (the reference drops the padded
    and inert writes)."""
    jc, pc, jp, pp = _cfgs(kv, softcap, pallas)
    rng = np.random.default_rng(20 + kv)
    B = 4
    k = rng.standard_normal((B, kv, C, 64), dtype=np.float32)
    v = rng.standard_normal((B, kv, C, 64), dtype=np.float32)
    start = np.array([3, 0, C - 5, 2])
    n_valid = np.array([min(ck, C - 3), 7, 5, 0])
    x = rng.standard_normal((B, ck, 128), dtype=np.float32)
    j_out, jk, jv = jax.jit(ja.chunk_prefill_attention, static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32))
    pk, pv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
    p_start = torch.as_tensor(start)
    p_out, pk2, pv2 = pa.chunk_prefill_attention(
        pc, pp, torch.as_tensor(x), pk, pv, p_start,
        torch.as_tensor(n_valid), pa.chunk_bias(p_start, ck, C))
    assert pk2 is pk and pv2 is pv                    # written in place
    for b in range(B):
        np.testing.assert_allclose(to_np(p_out)[b, :n_valid[b]],
                                   np.asarray(j_out)[b, :n_valid[b]],
                                   atol=1e-5)
    written = np.zeros((B, C), bool)
    for b in range(B):
        written[b, start[b]:start[b] + n_valid[b]] = True
    for got, want, old in ((pk, jk, k), (pv, jv, v)):
        got, want = to_np(got), np.asarray(want)
        np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[written],
                                   want.transpose(0, 2, 1, 3)[written],
                                   atol=1e-5)
        np.testing.assert_array_equal(got.transpose(0, 2, 1, 3)[~written],
                                      old.transpose(0, 2, 1, 3)[~written])
        np.testing.assert_array_equal(want.transpose(0, 2, 1, 3)[~written],
                                      old.transpose(0, 2, 1, 3)[~written])


# ---------------------------------------------------------------------- LM
@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_chunk_matches_reference(kernels):
    """``LM.prefill_chunk`` on the tiny config with bridged weights: the
    logits of active rows and every cache leaf (``pos`` of the inert row
    unchanged, untouched slots exactly as before) equal the reference's."""
    jcfg = tiny_variants(1)["small"][0].replace(use_pallas=kernels)
    jp, pp = bridged_params(jcfg)
    jm, pm = build_model(jcfg), LM(port_config(jcfg))
    rng = np.random.default_rng(5)
    B, C, ck = 3, 14, 16                        # a chunk longer than C
    jc = jm.init_cache(B, C)
    jc = {n: (jnp.asarray(rng.standard_normal(t.shape, dtype=np.float32),
                          t.dtype) if n in ("k", "v")
              else jnp.asarray([2, 9, 4], t.dtype)) for n, t in jc.items()}
    pc = {n: torch.as_tensor(np.array(t)) for n, t in jc.items()}
    old = {n: np.array(t) for n, t in jc.items()}
    toks = rng.integers(0, 128, (B, ck))
    start, nv = np.array([0, 9, 4]), np.array([8, 5, 0])
    jl, jc2 = jax.jit(jm.prefill_chunk)(
        jp, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(start, jnp.int32),
        jnp.asarray(nv, jnp.int32))
    pl, pc2 = pm.prefill_chunk(pp, pc, torch.as_tensor(toks),
                               torch.as_tensor(start), torch.as_tensor(nv))
    np.testing.assert_allclose(to_np(pl)[:2], np.asarray(jl)[:2], atol=1e-5)
    np.testing.assert_array_equal(to_np(pc2["pos"]), [8, 14, 4])
    np.testing.assert_array_equal(np.asarray(jc2["pos"]), [8, 14, 4])
    written = np.zeros((B, C), bool)
    for b in range(B):
        written[b, start[b]:start[b] + nv[b]] = True
    for n in ("k", "v"):                        # (L, B, KV, C, hd)
        got = to_np(pc2[n]).transpose(1, 3, 0, 2, 4)
        want = np.asarray(jc2[n]).transpose(1, 3, 0, 2, 4)
        np.testing.assert_allclose(got[written], want[written], atol=1e-5)
        np.testing.assert_array_equal(
            got[~written], old[n].transpose(1, 3, 0, 2, 4)[~written])


def test_chunks_over_a_prompt_reproduce_prefill():
    """Prefill continuation in chunks of 3 over an 8-token prompt gives the
    logits and the K/V of one monolithic prefill (the port alone)."""
    jcfg = tiny_variants(1)["small"][0]
    _, pp = bridged_params(jcfg)
    lm = LM(port_config(jcfg))
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, 128, (2, 8)))
    want, wcache = lm.prefill(pp, {"tokens": toks}, max_len=14)
    cache = lm.init_cache(2, 14, torch.device("cpu"))
    for s in range(0, 8, 3):
        n = min(3, 8 - s)
        chunk = torch.zeros((2, 3), dtype=torch.int64)
        chunk[:, :n] = toks[:, s:s + n]
        got, cache = lm.prefill_chunk(pp, cache, chunk,
                                      torch.full((2,), s),
                                      torch.full((2,), n))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(cache[n][..., :8, :],
                                   wcache[n][..., :8, :], atol=1e-5, rtol=0)
    assert cache["pos"].tolist() == [8, 8]


# ------------------------------------------------------------- launch plan
@pytest.mark.parametrize("ck,G,hd,rows", [
    (1, 8, 64, 8), (16, 8, 64, 64), (16, 8, 128, 32), (16, 5, 64, 60),
    (3, 8, 64, 24), (16, 32, 128, 32), (4, 1, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan(ck, G, hd, rows, dtype):
    """The rows one CUDA-core CTA takes: whole groups of G (a chunk token's
    heads share its bias row), as many tokens as 4096 accumulators hold, at
    most ck; the decode step takes its G rows. The block's shared memory
    fits one H100 block at G 8 and hd 64/128 in both dtypes. In bf16 at hd
    64 and 128 the chunk form plans the tensor-core route's 64 rows
    instead."""
    assert fd.chunk_rows(ck, G, hd) == rows
    esize = torch.tensor([], dtype=dtype).element_size()
    assert fd.smem_bytes(G, hd, esize, rows) <= fd.MAX_SMEM_BYTES
    q = torch.zeros((2, ck, 2, G, hd), dtype=dtype)
    k = torch.zeros((2, 2, 40, hd), dtype=dtype)
    tc, plan_rows, splits = fd.launch_plan(ck, G, hd, dtype, True)
    assert tc == (dtype == torch.bfloat16 and hd in (64, 128, 256))
    assert plan_rows == (fd.TC_ROWS if tc else rows)
    assert fd.check_args(q, k, k, torch.zeros((2, ck, 40)), True) == \
        (ck, tc, plan_rows, splits)


def _refusal_cases():
    q = torch.zeros((2, 4, 2, 8, 64))
    k = torch.zeros((2, 2, 40, 64))
    b = torch.zeros((2, 4, 40))
    return {
        "bias fp64": (q, k, k, b.double()),
        "bias (B, C)": (q, k, k, b[:, 0]),
        "bias rows != ck": (q, k, k, b[:, :3].contiguous()),
        "q strided": (q.transpose(2, 3).contiguous().transpose(2, 3), k, k, b),
        "k other dtype": (q, k.to(torch.bfloat16), k, b),
        "v other C": (q, k, k[:, :, :39].contiguous(), b),
        "G*hd > 4096": (torch.zeros((2, 4, 2, 40, 128)),
                        torch.zeros((2, 2, 40, 128)),
                        torch.zeros((2, 2, 40, 128)), b),
        "hd % 8": (torch.zeros((2, 4, 2, 8, 60)),
                   torch.zeros((2, 2, 40, 60)),
                   torch.zeros((2, 2, 40, 60)), b),
        "C = 0": (q, k[:, :, :0], k[:, :, :0], b[:, :, :0]),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_check_args_refuses(case):
    """What the kernel does not take raises before any launch (the CUDA
    wrapper calls ``check_args`` first); CPU tensors exercise the checks."""
    with pytest.raises((ValueError, TypeError)):
        fd.check_args(*_refusal_cases()[case], chunk=True)


@pytest.mark.parametrize("ck,G,hd,dtype,chunk,want", [
    (16, 8, 64, torch.bfloat16, True, (True, 64, fd.TC_SPLITS)),  # fused
    (16, 5, 64, torch.bfloat16, True, (True, 64, fd.TC_SPLITS)),  # 80 rows
    (1, 8, 64, torch.bfloat16, True, (True, 64, fd.TC_SPLITS)),   # ck 1
    (4, 80, 64, torch.bfloat16, True, (True, 64, fd.TC_SPLITS)),  # G*hd 5120
    (16, 8, 64, torch.float32, True, (False, 64, fd.SPLITS)),
    (16, 8, 128, torch.bfloat16, True, (True, 64, fd.TC_SPLITS)),
    (16, 5, 128, torch.float32, True, (False, 30, fd.SPLITS)),
    (1, 8, 64, torch.bfloat16, False, (False, 8, fd.SPLITS)),     # decode
    (1, 5, 128, torch.float32, False, (False, 5, fd.SPLITS)),
])
def test_tensor_core_launch_plan(ck, G, hd, dtype, chunk, want):
    """The route, rows and splits of one launch: the chunk form in bf16 at
    hd 64 and 128 on the tensor cores, 64 query rows a CTA at any G (a
    block spans 64 // G + 1 tokens or fewer) and ``TC_SPLITS`` CTAs per
    row block, with four CTAs' shared memory on one SM at hd 64 and two at
    128; the decode step (ck 1) and fp32 on the CUDA cores as before, in
    the shared memory of one H100 block. ``check_args`` returns the same
    plan."""
    plan = fd.launch_plan(ck, G, hd, dtype, chunk)
    assert plan == want
    tc, rows, _ = plan
    esize = torch.tensor([], dtype=dtype).element_size()
    if tc:
        assert (256 // hd) * fd.TC_SMEM_BYTES[hd] <= fd.MAX_SMEM_BYTES
        assert fd.TC_SMEM_BYTES[hd] == 5 * fd.TC_ROWS * hd * esize + 1024
    else:
        assert rows % G == 0 and rows * hd <= fd.MAX_GROUP_WIDTH
        assert fd.smem_bytes(G, hd, esize, rows) <= fd.MAX_SMEM_BYTES
    q = torch.zeros((2, ck, 2, G, hd) if chunk else (2, 2, G, hd),
                    dtype=dtype)
    k = torch.zeros((2, 2, 40, hd), dtype=dtype)
    bias = torch.zeros((2, ck, 40) if chunk else (2, 40))
    assert fd.check_args(q, k, k, bias, chunk) == (ck, *want)


@pytest.mark.parametrize("ck", [1, 5, 16])
@pytest.mark.parametrize("G", [8, 1, 3])
@pytest.mark.parametrize("hd", [128, 256])
def test_tensor_core_plan_at_wide_head_dims(hd, G, ck):
    """The chunk form in bf16 at hd 128 (yi-6b) and 256 (gemma-2b) plans
    the tensor-core route at any G and ck: 64 query rows a CTA,
    ``TC_SPLITS`` CTAs per row block, a Q tile and two-tile K and V
    rings of HD / 64 swizzled 8 KB sub-tiles in one H100 block (one CTA an
    SM at hd 256, two at 128); ``check_args`` returns that plan. The same
    shape in fp32 and the bf16 decode step keep the CUDA cores."""
    bf = torch.bfloat16
    assert fd.launch_plan(ck, G, hd, bf, True) == (
        True, fd.TC_ROWS, fd.TC_SPLITS)
    assert fd.TC_SMEM_BYTES[hd] == 5 * 64 * hd * 2 + 1024
    assert (256 // hd) * fd.TC_SMEM_BYTES[hd] <= fd.MAX_SMEM_BYTES
    k = torch.zeros((2, 2, 40, hd), dtype=bf)
    assert fd.check_args(torch.zeros((2, ck, 2, G, hd), dtype=bf), k, k,
                         torch.zeros((2, ck, 40)), True) == (
        ck, True, fd.TC_ROWS, fd.TC_SPLITS)
    assert not fd.launch_plan(ck, G, hd, torch.float32, True)[0]
    assert fd.launch_plan(1, G, hd, bf, False) == (False, G, fd.SPLITS)


def _tc_refusal_cases():
    """Operands of the tensor-core route (bf16, hd 64) that it refuses."""
    bf = torch.bfloat16
    q = torch.zeros((2, 4, 2, 8, 64), dtype=bf)
    k = torch.zeros((2, 2, 40, 64), dtype=bf)
    b = torch.zeros((2, 4, 40))
    return {
        "bias bf16": (q, k, k, b.to(bf)),
        "bias (B, C)": (q, k, k, b[:, 0]),
        "bias other C": (q, k, k, b[..., :39].contiguous()),
        "q strided": (q.transpose(2, 3).contiguous().transpose(2, 3), k, k, b),
        "q not 16-byte aligned": (
            torch.zeros(q.numel() + 1, dtype=bf)[1:].view(q.shape), k, k, b),
        "k fp32": (q, k.float(), k, b),
        "v other shape": (q, k, k[:, :1].contiguous(), b),
        "ck = 0": (q[:, :0], k, k, b[:, :0]),
        "C = 0": (q, k[:, :, :0], k[:, :, :0], b[:, :, :0]),
    }


@pytest.mark.parametrize("case", sorted(_tc_refusal_cases()))
def test_check_args_refuses_tensor_core_route(case):
    """What the tensor-core route does not take raises in ``check_args``,
    before any launch, as the CUDA-core route's refusals do."""
    with pytest.raises((ValueError, TypeError)):
        fd.check_args(*_tc_refusal_cases()[case], chunk=True)


@pytest.mark.parametrize("dtype,hd,chunk,lib", [
    (torch.bfloat16, 64, True, "flash_decode_chunk"),
    (torch.float32, 64, True, "flash_decode"),
    (torch.bfloat16, 128, True, "flash_decode_chunk"),
    (torch.bfloat16, 256, True, "flash_decode_chunk"),
    (torch.float32, 256, True, "flash_decode"),
    (torch.bfloat16, 64, False, "flash_decode"),
])
def test_wrapper_loads_the_planned_kernel_after_the_checks(monkeypatch,
                                                           dtype, hd, chunk,
                                                           lib):
    """On a non-CPU tensor (here meta) the wrapper checks, then loads the
    planned kernel's library: a refused operand raises before any library
    is loaded, and a valid one asks for the tensor-core library for the
    chunk form in bf16 (hd 64, 128, 256) and for the CUDA-core one
    otherwise; nothing falls back to the plain version, and no launch is
    counted."""
    asked = []

    def load(name):
        asked.append(name)
        raise RuntimeError("no kernels here")

    monkeypatch.setattr(fd.build, "load", load)
    wrap = fd.flash_decode_chunk if chunk else fd.flash_decode_bkhd
    q = torch.zeros((2, 3, 2, 8, hd) if chunk else (2, 2, 8, hd),
                    dtype=dtype, device="meta")
    k = torch.zeros((2, 2, 40, hd), dtype=dtype, device="meta")
    bias = torch.zeros((2, 3, 40) if chunk else (2, 40), device="meta")
    n0 = wrap.launches
    with pytest.raises(TypeError):
        wrap(q, k, k, bias.to(torch.float64))
    assert asked == []
    with pytest.raises(RuntimeError, match="no kernels here"):
        wrap(q, k, k, bias)
    assert asked == [lib] and wrap.launches == n0

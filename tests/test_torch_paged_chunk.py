"""The paged kernel's chunk form against the reference on the CPU.

``paged_flash_decode_chunk`` gives ck query tokens per row a length each
and is defined as the single-query paged decode at each token's lengths,
stacked: the reference's own per-token loop in
``repro/models/attention.py:paged_chunk_prefill_attention``. Here its
plain version (what the wrapper runs on CPU tensors) is held to the
reference's Pallas ``paged_flash_decode_bkhd`` (interpret mode) and its
oracle ``ref_paged_decode``, called once per chunk token and stacked; the
port's ``paged_chunk_prefill_attention`` with the kernels on is held to the
reference's Pallas path; the launch plan the CUDA wrapper computes is
checked against the kernel's limits. Inputs come from a numpy seed.
Tolerances as in tests/test_torch_paged.py: fp32 1e-5 absolute (both sides
accumulate in fp32, in different orders), bf16 3e-2 (each rounds an fp32
result to bf16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_tree, port_config, to_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as ja
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import attention as pa

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _chunk_np(rng, ck, G, ps, B=4, KV=2, hd=64, width=14, n_pages=12):
    """q (B, ck, KV, G, hd), pools, a table of ``width`` columns of which
    the first ``n_pages`` are passed (a column slice), and lengths (B, ck):
    row 0 crosses the 64-position tile border and page borders, row 1 is
    all 1, row 2 is clipped at T = n_pages * ps, row 3 alternates 0 and
    lengths crossing a page border."""
    P = B * width + 1
    T = n_pages * ps
    q = rng.standard_normal((B, ck, KV, G, hd), dtype=np.float32)
    kp = rng.standard_normal((KV, P, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((KV, P, ps, hd), dtype=np.float32)
    tables = rng.permutation(np.arange(1, P)).reshape(B, width)
    start = np.array([64 - ck // 2 - 1, 0, T - ck // 2, 2 * ps - 2])
    lengths = np.clip(start[:, None] + np.arange(ck)[None, :] + 1, 1, T)
    lengths[1] = 1
    lengths[3, ::2] = 0
    return (q, kp, vp, tables.astype(np.int32)[:, :n_pages],
            lengths.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,softcap", [(8, 0.0), (16, 30.0)])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("ck", [1, 5, 16])
def test_chunk_plain_matches_per_token_pallas_and_oracle(ck, G, ps, softcap,
                                                         dtype):
    q, kp, vp, tables, lengths = _chunk_np(np.random.default_rng(ck * G),
                                           ck, G, ps)
    assert lengths.max() == tables.shape[1] * ps    # clipped at T
    tdt = getattr(torch, dtype)
    got = to_np(pd.paged_flash_decode_chunk_plain(
        *(torch.as_tensor(a).to(tdt) for a in (q, kp, vp)),
        torch.as_tensor(tables), torch.as_tensor(lengths), softcap=softcap))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, kp, vp))
    jt = jnp.asarray(tables)
    for fn in (jops.paged_flash_decode, jref.ref_paged_decode):
        want = np.stack([np.asarray(
            fn(jq[:, j], jk, jv, jt, jnp.asarray(lengths[:, j]),
               softcap=softcap), np.float32) for j in range(ck)], axis=1)
        np.testing.assert_allclose(got, want, atol=ATOL[dtype])
    assert not got[lengths == 0].any()              # length 0 -> zeros


def test_chunk_wrapper_on_cpu_is_the_plain_version():
    """``ops.paged_flash_decode_chunk`` meets the operand rules (a strided
    q, int64 tables and lengths) and on CPU tensors gives the stack of
    ``ops.paged_flash_decode`` calls, launching nothing."""
    q, kp, vp, tables, lengths = (torch.as_tensor(a) for a in _chunk_np(
        np.random.default_rng(3), 16, 8, 16))
    qs = q.transpose(2, 3).contiguous().transpose(2, 3)    # strided view
    n0 = pd.paged_flash_decode_bkhd.launches
    got = ops.paged_flash_decode_chunk(qs, kp, vp, tables.long(),
                                       lengths.long(), softcap=30.0)
    want = torch.stack([ops.paged_flash_decode(
        q[:, j], kp, vp, tables, lengths[:, j], softcap=30.0)
        for j in range(q.shape[1])], dim=1)
    assert pd.paged_flash_decode_bkhd.launches == n0
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def _cfgs(kv, softcap):
    from repro.configs import get_config, smoke_variant
    jc = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=128, num_heads=8, num_kv_heads=kv, head_dim=64,
        attn_logit_softcap=softcap, use_pallas=True)
    jp = ja.init_attention(jax.random.PRNGKey(1), jc)
    return jc, port_config(jc), jp, {k: torch.as_tensor(v)
                                     for k, v in np_tree(jp).items()}


@pytest.mark.parametrize("kv,softcap", [(1, 0.0), (2, 30.0)])
def test_paged_chunk_prefill_attention_one_launch_path(kv, softcap):
    """A 16-token chunk at GQA group 8 or 4 (the port's single chunk
    launch, here its plain version) against the reference's 16 Pallas
    calls: per-token lengths crossing pages, a row whose chunk ends at T
    (its padded tokens clipped), an inert row."""
    jc, pc, jp, pp = _cfgs(kv, softcap)
    assert pc.use_kernels
    rng = np.random.default_rng(20 + kv)
    B, ck, ps, max_pages = 3, 16, 8, 6
    P = B * max_pages + 1
    kp = rng.standard_normal((kv, P, ps, 64), dtype=np.float32)
    vp = rng.standard_normal((kv, P, ps, 64), dtype=np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
    pt = pt.astype(np.int32)
    start = np.array([3, 40, 0])
    n_valid = np.array([16, 8, 0])                  # row 1 ends at T = 48
    x = rng.standard_normal((B, ck, 128), dtype=np.float32)
    j_out, _, _ = jax.jit(ja.paged_chunk_prefill_attention,
                          static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(start, jnp.int32),
        jnp.asarray(n_valid, jnp.int32))
    p_out, _, _ = pa.paged_chunk_prefill_attention(
        pc, pp, torch.as_tensor(x), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(pt), torch.as_tensor(start), torch.as_tensor(n_valid))
    for b in range(B):
        np.testing.assert_allclose(to_np(p_out)[b, :n_valid[b]],
                                   np.asarray(j_out)[b, :n_valid[b]],
                                   atol=1e-5)


@pytest.mark.parametrize("ck,G,hd,dtype,chunk,want", [
    (16, 8, 64, torch.bfloat16, True, (True, 64, pd.CHUNK_SPLITS)),
    (16, 8, 64, torch.float32, True, (False, 64, pd.CHUNK_SPLITS)),
    (5, 4, 128, torch.bfloat16, True, (True, 64, pd.CHUNK_SPLITS)),
    (16, 5, 128, torch.float32, True, (False, 32, pd.CHUNK_SPLITS)),
    (1, 8, 64, torch.bfloat16, False, (False, 8, pd.SPLITS)),
    (1, 8, 128, torch.float32, False, (False, 8, pd.SPLITS)),
])
def test_launch_plan(ck, G, hd, dtype, chunk, want):
    """The plan the wrapper passes the kernel: the chunk form in bf16 at
    hd 64, 128 and 256 on the tensor cores in blocks of 64 query rows;
    every other launch on the CUDA cores with at most 4096 accumulators a
    CTA; each in the shared memory of one H100 block; more CTAs per row
    block for the decode step than for the chunk."""
    tc, rows, splits = pd.launch_plan(ck, G, hd, dtype, chunk)
    assert (tc, rows, splits) == want
    assert rows * hd <= pd.MAX_ROW_WIDTH or tc
    esize = torch.tensor([], dtype=dtype).element_size()
    assert (pd.TC_SMEM_BYTES[hd] if tc else pd.simt_smem_bytes(
        rows, hd, esize)) <= pd.MAX_SMEM_BYTES


@pytest.mark.parametrize("ck", [1, 5, 16])
@pytest.mark.parametrize("G", [8, 1, 3])
@pytest.mark.parametrize("hd", [128, 256])
def test_tensor_core_plan_at_wide_head_dims(hd, G, ck):
    """The chunk form in bf16 at hd 128 (yi-6b) and 256 (gemma-2b) plans
    the tensor-core route at any G and ck: 64 query rows a CTA,
    ``CHUNK_SPLITS`` CTAs per row block, a Q tile and two-tile K and V
    rings of HD / 64 swizzled 8 KB sub-tiles in one H100 block (one CTA an
    SM at hd 256, two at 128); ``check_args`` returns that plan. The same
    shape in fp32 and the bf16 decode step keep the CUDA cores."""
    bf = torch.bfloat16
    assert pd.launch_plan(ck, G, hd, bf, True) == (
        True, pd.TC_ROWS, pd.CHUNK_SPLITS)
    assert pd.TC_SMEM_BYTES[hd] == 5 * 64 * hd * 2 + 1024
    assert (256 // hd) * pd.TC_SMEM_BYTES[hd] <= pd.MAX_SMEM_BYTES
    pool = torch.zeros((2, 9, 8, hd), dtype=bf)
    tables = torch.zeros((3, 4), dtype=torch.int32)
    assert pd.check_args(torch.zeros((3, ck, 2, G, hd), dtype=bf), pool,
                         pool, tables, torch.ones((3, ck), dtype=torch.int32),
                         True) == (ck, True, pd.TC_ROWS, pd.CHUNK_SPLITS)
    assert not pd.launch_plan(ck, G, hd, torch.float32, True)[0]
    assert pd.launch_plan(1, G, hd, bf, False) == (False, G, pd.SPLITS)

"""The kernels' plain PyTorch versions (what the wrappers run on CPU
tensors) against the reference: its Pallas kernels through
``repro.kernels.ops`` (interpret mode on the CPU, as the reference's own
kernel tests run them) and its ``repro.kernels.ref`` oracles. fp32,
tolerance 1e-5 absolute. The CUDA kernels themselves are held against the
plain versions on the card, in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.models.ssd import ssd_chunked

ATOL = 1e-5


def _qkv(rng, B, S, H, KV, hd):
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("S", [16, 40, 128])
def test_plain_flash_prefill_matches_pallas_and_oracle(S, window, softcap, G):
    KV, hd = 2, 64
    q, k, v = _qkv(np.random.default_rng(S + window), 1, S, KV * G, KV, hd)
    got = to_np(ops.flash_prefill(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), window=window,
                                  softcap=softcap))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jops.flash_prefill(jq, jk, jv, window=window, softcap=softcap)
    oracle = ref.ref_flash_prefill(jq, jk, jv, window=window, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATOL)


def _decode_inputs(rng, B, KV, G, hd, C, masked_rows):
    q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    bias = np.zeros((B, C), np.float32)
    for b in masked_rows:                  # invalid slots carry -1e9
        bias[b, rng.random(C) < 0.5] = -1e9
        bias[b, 0] = 0.0
    return q, k, v, bias


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("C", [7, 100, 576])
@pytest.mark.parametrize("G", [1, 8])
def test_plain_flash_decode_matches_pallas_and_oracle(C, G, softcap):
    B, KV, hd = 3, 2, 64
    q, k, v, bias = _decode_inputs(np.random.default_rng(C + G), B, KV, G, hd,
                                   C, masked_rows=(0, 2))
    got = to_np(ops.flash_decode_bkchd(*map(torch.as_tensor, (q, k, v, bias)),
                                       softcap=softcap))
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    pallas = jops.flash_decode_bkchd(jq, jk, jv, jb, softcap=softcap)
    # the oracle takes the (B,1,H,hd) / (B,C,KV,hd) layout
    oracle = ref.ref_flash_decode(jq.reshape(B, 1, KV * G, hd),
                                  jk.transpose(0, 2, 1, 3),
                                  jv.transpose(0, 2, 1, 3), jb,
                                  softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(got.reshape(B, 1, KV * G, hd),
                               np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize("C", [9, 64])
def test_flash_decode_model_layout_matches_reference_ops(C):
    """``ops.flash_decode`` (B,1,H,hd) / (B,C,KV,hd) relayout form."""
    rng = np.random.default_rng(C)
    B, KV, G, hd = 2, 2, 4, 64
    q = rng.standard_normal((B, 1, KV * G, hd), dtype=np.float32)
    k = rng.standard_normal((B, C, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, C, KV, hd), dtype=np.float32)
    bias = np.where(rng.random((B, C)) < 0.3, -1e9, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    got = to_np(ops.flash_decode(*map(torch.as_tensor, (q, k, v, bias))))
    want = jops.flash_decode(*map(jnp.asarray, (q, k, v, bias)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    q, k, v = map(torch.as_tensor, _qkv(rng, 1, 16, 4, 2, 64))
    torch.testing.assert_close(
        fp.flash_prefill_bshd(q, k, v), fp.flash_prefill_plain(q, k, v))
    qd, kd, vd, bd = map(torch.as_tensor,
                         _decode_inputs(rng, 1, 2, 2, 64, 10, ()))
    torch.testing.assert_close(fd.flash_decode_bkhd(qd, kd, vd, bd),
                               fd.flash_decode_plain(qd, kd, vd, bd))
    pool = torch.as_tensor(rng.standard_normal((2, 5, 4, 64),
                                               dtype=np.float32))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    qp = torch.as_tensor(rng.standard_normal((2, 2, 2, 64),
                                             dtype=np.float32))
    want = pd.paged_flash_decode_plain(qp, pool, pool, tables, lengths)
    torch.testing.assert_close(
        ops.paged_flash_decode(qp, pool, pool, tables, lengths), want)
    # ops meets the kernel's operand rules: int64 indices, a strided q
    qs = qp.transpose(0, 1).contiguous().transpose(0, 1)
    torch.testing.assert_close(
        ops.paged_flash_decode(qs, pool, pool, tables.long(), lengths.long()),
        want)
    xs = torch.as_tensor(rng.standard_normal((2, 12, 3, 16),
                                             dtype=np.float32))
    dts = torch.rand((2, 12, 3))
    bcs = torch.as_tensor(rng.standard_normal((2, 12, 8), dtype=np.float32))
    A = -torch.rand(3)
    torch.testing.assert_close(
        ops.ssd_scan(xs, dts, A, bcs, bcs, chunk=4),
        ssd_chunked(xs, dts, A, bcs, bcs, 4))
    assert ops.launch_counts() == {"flash_prefill": 0, "flash_decode": 0,
                                   "flash_decode_chunk": 0,
                                   "paged_decode": 0, "ssd_scan": 0}


def test_causal_window_mask():
    m = fp.causal_window_mask(6, 3, "cpu").numpy()
    i, j = np.indices((6, 6))
    np.testing.assert_array_equal(m, (j <= i) & (j > i - 3))
    np.testing.assert_array_equal(fp.causal_window_mask(5, 0, "cpu").numpy(),
                                  np.tril(np.ones((5, 5), bool)))

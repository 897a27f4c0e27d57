"""The attention kernels' plain versions at head dim 128 (internvl2-26b's
G 6, yi-6b's and deepseek-67b's G 8, qwen3-moe-235b-a22b's G 16) against
the reference, and their CUDA launch plans at internvl2-26b's serve shapes.

The reference runs its Pallas kernels in interpret mode (as its own kernel
tests do on the CPU) and its ``kernels/ref.py`` oracles. Tolerances: fp32
1e-5 absolute (sums in other orders); bf16 3e-2, the reference kernel
tests' own (each side rounds an fp32 result to bf16). The launch plans are
CPU functions (``check_args``, ``launch_plan``, ``smem_bytes``): the
kernels themselves, the pipelined ``wgmma`` prefill and the tensor-core
decode step in bf16 at hd 128, are held to these plain versions on the card
(``tests/test_torch_cuda.py``, chip_smoke's VLM phase)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
HD = 128


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
@pytest.mark.parametrize("B,S,H,KV,window,softcap", [
    (1, 70, 12, 2, 0, 0.0),           # internvl2-26b's group of 6, ragged S
    (2, 50, 6, 1, 16, 30.0),          # G 6, window, softcap
    (1, 64, 16, 2, 0, 0.0),           # yi-6b's and deepseek-67b's G 8
    (1, 40, 16, 1, 0, 30.0),          # qwen3-moe's G 16, softcap
])
def test_plain_prefill_matches_pallas_and_oracle(B, S, H, KV, window,
                                                 softcap, dtype):
    rng = np.random.default_rng(S + H)
    (q, k, v), (jq, jk, jv) = _both(
        [_np(rng, B, S, H, HD), _np(rng, B, S, KV, HD),
         _np(rng, B, S, KV, HD)], dtype)
    got = fp.flash_prefill_bshd(q, k, v, window=window, softcap=softcap)
    _close(got, [jops.flash_prefill(jq, jk, jv, window=window,
                                    softcap=softcap),
                 jref.ref_flash_prefill(jq, jk, jv, window=window,
                                        softcap=softcap)], dtype)


# ------------------------------------------------------------- flash_decode
def _decode_np(rng, B, KV, G, C):
    bias = np.where(rng.random((B, C)) < 0.8, 0.0, -1e9).astype(np.float32)
    bias[:, 0] = 0.0
    return (_np(rng, B, KV, G, HD), _np(rng, B, KV, C, HD),
            _np(rng, B, KV, C, HD), bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,C,softcap", [
    (2, 8, 6, 100, 0.0),              # internvl2-26b's heads
    (3, 2, 6, 576, 30.0),             # G 6 at the serve ring, softcap
    (2, 2, 8, 96, 0.0),               # G 8
    (2, 1, 16, 130, 30.0),            # G 16: the step kernel's whole M
])
def test_plain_decode_matches_pallas_and_oracle(B, KV, G, C, softcap, dtype):
    q, k, v, bias = _decode_np(np.random.default_rng(C + G), B, KV, G, C)
    (tq, tk, tv), (jq, jk, jv) = _both([q, k, v], dtype)
    got = fd.flash_decode_bkhd(tq, tk, tv, torch.as_tensor(bias),
                               softcap=softcap)
    pallas = jops.flash_decode_bkchd(jq, jk, jv, jnp.asarray(bias),
                                     softcap=softcap)
    oracle = jref.ref_flash_decode(
        jq.reshape(B, 1, KV * G, HD), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), jnp.asarray(bias), softcap=softcap)
    _close(got, [pallas], dtype)
    _close(got.reshape(B, 1, KV * G, HD), [oracle], dtype)


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plans_at_internvls_serve_shapes(dtype):
    """The CUDA wrappers' checks pass at internvl2-26b's serve shapes (B 8,
    S 768 with the image prefix, 48 heads on 8 KV heads of hd 128, the ring
    C 576). In bf16 flash_prefill plans the pipelined ``wgmma`` kernel (one
    head a CTA, 82,944 bytes: two CTAs an SM) and the decode step the
    tensor-core step kernel (16 rows, ``STEP_SPLITS[128]`` CTAs per (b,
    kv-head), five CTAs' shared memory on an SM); in fp32 both keep the
    CUDA cores."""
    bf = dtype == torch.bfloat16
    z = lambda *s: torch.zeros(s, dtype=dtype)            # noqa: E731
    fp.check_args(z(8, 768, 48, HD), z(8, 768, 8, HD), z(8, 768, 8, HD), 0)
    assert fp.launch_plan(HD, dtype) == (
        ("flash_prefill_wide_kernel", 128, 1) if bf
        else ("flash_prefill_simt_kernel", 128, 1))
    assert fp.smem_bytes(HD, dtype) == (82_944 if bf else 114_688)
    assert 2 * fp.smem_bytes(HD, dtype) <= fp.MAX_SMEM_BYTES
    k = z(8, 8, 576, HD)
    plan = fd.check_args(z(8, 8, 6, HD), k, k, torch.zeros(8, 576), False)
    assert plan == ((1, True, fd.STEP_ROWS, fd.STEP_SPLITS[HD]) if bf
                    else (1, False, 6, fd.SPLITS))
    assert fd.KERNELS[plan[1], False][1] == (
        "flash_decode_step_kernel" if bf else "flash_decode_kernel")
    assert 5 * fd.STEP_SMEM_BYTES[HD] <= fd.MAX_SMEM_BYTES

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips through the ``cuda`` fixture where there is none. This file imports
no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in different
orders); bf16 1e-2 (both round an fp32 result to bf16, at most one bf16
ulp apart for outputs of magnitude < 2).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

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
    # B, KV, G, hd, C, softcap, masked_rows
    (8, 4, 8, 64, 576, 0.0, False),   # serve path: tinyllama at C = 512+64
    (2, 2, 4, 64, 100, 0.0, True),    # ragged C, -1e9 bias on some slots
    (3, 1, 8, 128, 64, 30.0, False),  # MQA, hd 128, softcap
    (1, 4, 1, 64, 7, 0.0, True),      # G 1, C below one tile
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
    if masked:
        bias[:, C // 2:] = -1e9
    n0 = fd.flash_decode_bkhd.launches
    out = fd.flash_decode_bkhd(q, k, v, bias, softcap=softcap)
    torch.cuda.synchronize()
    assert fd.flash_decode_bkhd.launches == n0 + 1
    want = fd.flash_decode_plain(q, k, v, bias, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


PREFILL_CASES = [
    # B, S, H, KV, hd, window, softcap
    (8, 512, 32, 4, 64, 0, 0.0),      # serve path: tinyllama, 512 prompt
    (2, 40, 4, 1, 64, 0, 0.0),        # ragged S (not a tile multiple)
    (1, 130, 8, 2, 64, 8, 30.0),      # sliding window + softcap
    (2, 96, 4, 4, 128, 0, 0.0),       # hd 128, G 1
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

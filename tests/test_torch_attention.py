"""``attention_forward`` and ``decode_attention`` against the reference
with its Pallas path on (interpret mode) and off, the port's kernel switch
on (the wrappers' plain versions on CPU tensors) and off. fp32, tolerance
1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_tree, port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models import attention as ja
from repro_torch.models import attention as pa

ATOL = 1e-5


def _cfgs(kernels, window=0, kv=2):
    jc = jsmoke(jget("tinyllama-1.1b")).replace(
        d_model=128, num_heads=4, num_kv_heads=kv, head_dim=64,
        sliding_window=window, use_pallas=kernels)
    return jc, port_config(jc)


def _params(jc):
    jp = ja.init_attention(jax.random.PRNGKey(0), jc)
    return jp, {k: torch.as_tensor(v) for k, v in np_tree(jp).items()}


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("kernels", [False, True])
def test_attention_forward(kernels, window, kv):
    jc, pc = _cfgs(kernels, window, kv)
    jp, pp = _params(jc)
    B, S = 2, 24
    x = np.random.default_rng(0).standard_normal((B, S, 128),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = ja.attention_forward(jc, jp, jnp.asarray(x), jnp.asarray(pos),
                                window)
    got = pa.attention_forward(pc, pp, torch.as_tensor(x),
                               torch.as_tensor(pos), window)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("pos0", [3, 15, 40])          # 40: ring wrap (C=16)
@pytest.mark.parametrize("kernels", [False, True])
def test_decode_attention(kernels, pos0, window):
    jc, pc = _cfgs(kernels, window)
    jp, pp = _params(jc)
    rng = np.random.default_rng(pos0)
    B, KV, C, hd = 3, 2, 16, 64
    x = rng.standard_normal((B, 1, 128), dtype=np.float32)
    kc = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    vc = rng.standard_normal((B, KV, C, hd), dtype=np.float32)
    pos = np.array([pos0, pos0 + 1, max(pos0 - 3, 0)], np.int32)
    ja_out, jk, jv = ja.decode_attention(jc, jp, jnp.asarray(x),
                                         jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(pos), window)
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    out, k2, v2 = pa.decode_attention(pc, pp, torch.as_tensor(x), tk, tv,
                                      torch.as_tensor(pos, dtype=torch.int64),
                                      window)
    assert k2 is tk and v2 is tv               # written in place
    np.testing.assert_allclose(to_np(out), np.asarray(ja_out), atol=ATOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(to_np(tv), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("window", [0, 4])
def test_causal_mask_bias(window, offset):
    want = ja.causal_mask_bias(6, 12, offset, window)
    got = pa.causal_mask_bias(6, 12, offset, window)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_gqa_attend(softcap):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 10, 4, 64), dtype=np.float32)
    k = rng.standard_normal((2, 10, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 10, 2, 64), dtype=np.float32)
    bias = np.array(ja.causal_mask_bias(10, 10, 0, 0))
    want = ja.gqa_attend(*map(jnp.asarray, (q, k, v, bias)), softcap)
    got = pa.gqa_attend(*map(torch.as_tensor, (q, k, v, bias)), softcap)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)

"""Sinusoidal positions and ``layer_norm`` in the port, against the
reference, on the CPU.

``layers.sinusoidal_positions`` (the numpy table with float64 angles the
full-sequence paths add) must equal the reference's bit for bit;
``LM._sinusoid_pe`` (fp32 angles on the device, the per-position paths'
form) within 2e-6 plus two fp32 roundings of each angle (pos · 2^-23) at
positions up to 4095 (fp32 ``pow``, ``sin`` and ``cos`` of two
libraries); ``layer_norm`` within 1e-6. Then a dense smoke config with
``rope_theta = 0`` (sinusoidal positions in place of RoPE, which the
reference also supports) through ``apply``, ``prefill``, ``decode_step``,
``prefill_chunk``, ``verify_chunk`` and the paged admit, decode, chunk and
verify forms against the reference (the MoE model test's cases: logits
within 2e-4 absolute and 1e-4 relative, greedy tokens and every written
cache entry equal), with the kernels off and on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multimodal as mm
import test_torch_moe_model as lm_cases
from _torch_parity import port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro_torch.models import layers
from repro_torch.models.model import LM

JCFG = jsmoke(jget("tinyllama-1.1b")).replace(
    rope_theta=0.0, name="tinyllama-sinusoid-smoke")


@pytest.mark.parametrize("S,D", [(1, 2), (32, 256), (1500, 384),
                                 (777, 6144)])
def test_sinusoidal_positions_equal_reference(S, D):
    got = layers.sinusoidal_positions(S, D)
    want = jlayers.sinusoidal_positions(S, D)
    assert got.dtype == np.float32 and got.shape == (S, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d_model", [256, 384])
def test_sinusoid_pe_matches_reference(d_model):
    """Positions of any shape, small and large; and its difference from the
    float64 table stays in the last bits (the two forms are not unified)."""
    jcfg = JCFG.replace(d_model=d_model)
    pos = np.array([[0, 1, 7], [511, 2048, 4095]])
    want = jbuild(jcfg)._sinusoid_pe(jnp.asarray(pos, jnp.int32))
    got = LM(port_config(jcfg))._sinusoid_pe(torch.as_tensor(pos))
    assert got.dtype == torch.float32 and got.shape == (2, 3, d_model)
    # fp32 angles: pos * inv rounds to within pos * 2^-24 of each other's,
    # so the bound grows with the position (2e-6 at position 0)
    bound = 2e-6 + pos[..., None] * 2.0 ** -23
    assert (np.abs(to_np(got) - np.asarray(want)) <= bound).all()
    table = layers.sinusoidal_positions(4096, d_model)[pos]
    assert np.abs(to_np(got) - table).max() < 1e-3


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal((2, 64)).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), 1e-5)
    got = layers.layer_norm(torch.as_tensor(x), torch.as_tensor(w),
                            torch.as_tensor(b), 1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    got16 = layers.layer_norm(torch.as_tensor(x).bfloat16(),
                              torch.as_tensor(w), torch.as_tensor(b), 1e-5)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_ropeless_apply_and_decode_match_reference(kernels):
    jcfg = JCFG.replace(use_pallas=kernels)
    mm.apply_case(jcfg)
    mm.decode_case(jcfg)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_ropeless_chunk_and_verify_match_reference(kernels):
    lm_cases.test_moe_lm_matches_reference(
        JCFG.name, JCFG.replace(use_pallas=kernels))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_ropeless_paged_forms_match_reference(kernels):
    lm_cases.test_moe_paged_lm_matches_reference(
        JCFG.name, JCFG.replace(use_pallas=kernels))


def test_positions_reach_the_logits():
    """The sinusoid is what tells positions apart without RoPE: the same
    token at two positions of a chunk gives different logits."""
    _, pp = mm.bridged_params(JCFG)
    pm = LM(port_config(JCFG))
    toks = torch.full((1, 4), 5)
    logits, _ = pm.apply(pp, {"tokens": toks})
    assert float((logits[0, 1] - logits[0, 2]).abs().max()) > 1e-3

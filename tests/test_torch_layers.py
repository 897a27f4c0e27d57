"""``repro_torch.models.layers`` against ``repro.models.layers`` on the same
numpy inputs (fp32; tolerance 1e-5 absolute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_tree, port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models import layers as jl
from repro_torch.models import layers as pl

ATOL = 1e-5


def _cfg(**kw):
    return jsmoke(jget("tinyllama-1.1b")).replace(
        d_model=64, d_ff=96, vocab_size=200, **kw)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 64)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(shape, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32) * 3
    w = rng.standard_normal(shape[-1:], dtype=np.float32) * 0.1
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
    got = pl.rms_norm(torch.as_tensor(x), torch.as_tensor(w), eps)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 0.0])
@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(theta, offset):
    """Positions beyond the sequence length (decode offsets) included."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 64), dtype=np.float32)
    pos = (np.arange(6)[None] + offset + np.array([[0], [37]])).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = pl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(mlp_type):
    cfg = _cfg(mlp_type=mlp_type)
    p = np_tree(jl.init_mlp(jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(2).standard_normal((2, 4, 64), dtype=np.float32)
    want = jl.apply_mlp(cfg, jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x))
    got = pl.apply_mlp(port_config(cfg),
                       {k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["tinyllama-smoke", "gemma-2b-smoke"])
def test_embed(name):
    cfg = _cfg(name=name)
    p = np_tree(jl.init_embed(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(3).integers(0, 200, (2, 7))
    want = jl.embed(cfg, jax.tree_util.tree_map(jnp.asarray, p),
                    jnp.asarray(toks), jnp.float32)
    got = pl.embed(port_config(cfg),
                   {k: torch.as_tensor(v) for k, v in p.items()},
                   torch.as_tensor(toks), torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("tie", [False, True])
def test_unembed(softcap, tie):
    cfg = _cfg(attn_logit_softcap=softcap, tie_embeddings=tie)
    p = np_tree(jl.init_embed(jax.random.PRNGKey(1), cfg))
    x = np.random.default_rng(4).standard_normal((2, 3, 64),
                                                 dtype=np.float32) * 20
    want = jl.unembed(cfg, jax.tree_util.tree_map(jnp.asarray, p),
                      jnp.asarray(x))
    got = pl.unembed(port_config(cfg),
                     {k: torch.as_tensor(v) for k, v in p.items()},
                     torch.as_tensor(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("vocab", [200, 256, 1000])
def test_vocab_mask(vocab):
    cfg = _cfg().replace(vocab_size=vocab)
    np.testing.assert_array_equal(pl.vocab_mask(port_config(cfg)),
                                  jl.vocab_mask(cfg))


@pytest.mark.parametrize("shape", [(512, 256), (64,)])
def test_truncated_normal_init_matches_reference_distribution(shape):
    """Same distribution (truncated at ±2σ, σ = 1/√fan_in) from a seeded
    torch.Generator; values differ from jax.random's, moments agree."""
    g = torch.Generator().manual_seed(0)
    got = to_np(pl.truncated_normal_init(g, shape, 1.0))
    want = np.asarray(jl.truncated_normal_init(jax.random.PRNGKey(0), shape,
                                               1.0))
    std = 1.0 / np.sqrt(shape[0] if len(shape) >= 2 else 1)
    assert np.abs(got).max() <= 2 * std + 1e-6
    assert np.abs(want).max() <= 2 * std + 1e-6
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.1)
    assert abs(got.mean()) < 0.1 * std

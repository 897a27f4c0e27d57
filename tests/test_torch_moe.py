"""The MoE layer in the port (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``.

The reference's four cases (``tests/test_moe.py``) run on the port's
functions with the reference's ``init_moe`` weights. Then the port's
``apply_moe`` is held to the reference's on the same fp32 weights and
seeded numpy inputs within 1e-4 (absolute and relative: sums in other
orders), dropless and at capacity factor 1.0 with overflow, with the
three metrics equal; the reference's overflow write (slot 0 of an
overflowing expert reads zero, ``src/repro/models/moe.py:91-93``) is
shown on a case built to overflow; a zero router, where every
probability ties, picks the reference's experts; ``moe_capacity`` equals
the reference's over a grid; and two calls are bitwise equal."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models import moe as jmoe
from repro_torch.models import moe as pmoe

ATOL = RTOL = 1e-4


def _setup(E=4, k=2, D=32, F=64, B=2, S=8, seed=1):
    """The reference test's setup: qwen3-moe's smoke variant at (E, k, D,
    F), its ``init_moe`` weights, a normal (B, S, D) input (numpy)."""
    jcfg = jsmoke(jget("qwen3-moe-235b-a22b")).replace(
        d_model=D, d_ff=F, num_experts=E, experts_per_token=k)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return jcfg, jp, x


def _port(jcfg, jp, x):
    return (port_config(jcfg),
            {n: torch.tensor(np.asarray(v)) for n, v in jp.items()},
            torch.tensor(x))


# ------------------------------------------- the reference's four cases
def test_grouped_dispatch_matches_dense_oracle():
    cfg, p, x = _port(*_setup())
    y, metrics = pmoe.apply_moe(cfg, p, x, capacity_factor=8.0)
    want = pmoe.apply_moe_dense_oracle(cfg, p, x)
    assert float(metrics["drop_fraction"]) == 0.0
    np.testing.assert_allclose(to_np(y), to_np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 3)])
def test_moe_shapes_and_finiteness(E, k):
    cfg, p, x = _port(*_setup(E=E, k=k))
    y, metrics = pmoe.apply_moe(cfg, p, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(metrics["aux_loss"]) >= 1.0 - 1e-3


def test_capacity_drops_bounded():
    cfg, p, x = _port(*_setup(B=2, S=32))
    _, metrics = pmoe.apply_moe(cfg, p, x, capacity_factor=1.0)
    assert 0.0 <= float(metrics["drop_fraction"]) < 0.5


def test_aux_loss_uniform_router_is_one():
    cfg, p, x = _port(*_setup(E=4, k=2, B=4, S=64))
    p["router"] = torch.zeros_like(p["router"])
    _, metrics = pmoe.apply_moe(cfg, p, x)
    assert abs(float(metrics["aux_loss"]) - 1.0) < 0.05


# ------------------------------------------------ port against reference
# (E, k, B, S, capacity factor): dropless (8.0, 16.0), the config's 1.25,
# and 1.0, which overflows at these sizes; (40, 8) is granite's routing
CASES = [(4, 2, 2, 8, 8.0), (8, 3, 2, 16, 16.0), (4, 2, 2, 32, 1.0),
         (8, 2, 3, 16, None), (40, 8, 2, 16, 1.0), (40, 8, 8, 1, 1.25)]


def _both(E, k, B, S, cf, seed=1):
    jcfg, jp, x = _setup(E=E, k=k, B=B, S=S, seed=seed)
    jy, jm = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), capacity_factor=cf)
    cfg, p, xt = _port(jcfg, jp, x)
    py, pm = pmoe.apply_moe(cfg, p, xt, capacity_factor=cf)
    return (np.asarray(jy), {n: float(v) for n, v in jm.items()},
            to_np(py), {n: float(v) for n, v in pm.items()})


@pytest.mark.parametrize("E,k,B,S,cf", CASES)
def test_apply_moe_matches_reference(E, k, B, S, cf):
    jy, jm, py, pm = _both(E, k, B, S, cf)
    np.testing.assert_allclose(py, jy, atol=ATOL, rtol=RTOL)
    if cf in (8.0, 16.0):
        assert pm["drop_fraction"] == 0.0
    if (E, k, cf) == (40, 8, 1.0):
        assert pm["drop_fraction"] > 0.0         # overflow is exercised


@pytest.mark.parametrize("E,k,B,S,cf", CASES)
def test_metrics_match_reference(E, k, B, S, cf):
    _, jm, _, pm = _both(E, k, B, S, cf)
    assert set(pm) == {"aux_loss", "router_entropy", "drop_fraction"}
    for n in pm:
        assert pm[n] == pytest.approx(jm[n], rel=1e-5, abs=1e-6), n
    assert pm["drop_fraction"] == jm["drop_fraction"]


def test_overflow_zeroes_slot_zero_as_the_reference_does():
    """Every token picks expert 0 (k 1): 16 picks at capacity 8. Tokens
    0-7 hold its slots, 8-15 are dropped, and slot 0 reads zero after the
    dropped picks' writes, so token 0's output is 0 although
    ``drop_fraction`` counts it as kept (0.5, not 9/16)."""
    E, D, T = 4, 32, 16
    jcfg, jp, _ = _setup(E=E, k=1, D=D)
    rng = np.random.default_rng(2)
    x = np.abs(rng.standard_normal((1, T, D))).astype(np.float32) + 0.1
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 1.0                           # expert 0 wins every token
    jp = dict(jp, router=jnp.asarray(router))
    jy, jm = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), capacity_factor=1.0)
    cfg, p, xt = _port(jcfg, jp, x)
    assert pmoe.moe_capacity(T, cfg, 1.0) == 8
    py, pm = pmoe.apply_moe(cfg, p, xt, capacity_factor=1.0)
    py, jy = to_np(py)[0], np.asarray(jy)[0]
    np.testing.assert_allclose(py, jy, atol=ATOL, rtol=RTOL)
    assert not np.any(py[0]) and not np.any(jy[0])     # slot 0: zero
    assert np.all(np.abs(py[1:8]).max(-1) > 0)          # slots 1-7 kept
    assert not np.any(py[8:])                           # dropped
    assert float(pm["drop_fraction"]) == float(jm["drop_fraction"]) == 0.5


@pytest.mark.parametrize("router", ["zero", "tied-columns"])
def test_tied_probabilities_pick_the_reference_experts(router):
    """A zero router ties every probability; duplicated router columns tie
    pairs. ``route`` picks the lower expert id first, as ``jax.lax.top_k``
    does, so the ids and the layer's output equal the reference's."""
    jcfg, jp, x = _setup(E=8, k=3, B=2, S=8)
    r = np.asarray(jp["router"]).copy()
    if router == "zero":
        r[:] = 0.0
    else:
        r[:, 1::2] = r[:, 0::2]
    jp = dict(jp, router=jnp.asarray(r))
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 32)) @ jnp.asarray(r))
    jvals, jids = jax.lax.top_k(probs, 3)
    cfg, p, xt = _port(jcfg, jp, x)
    _, gates, ids = pmoe.route(cfg, p, xt.reshape(-1, 32))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        gates.numpy(), np.asarray(jvals / jvals.sum(-1, keepdims=True)),
        atol=1e-6)
    if router == "zero":
        assert (ids.numpy() == np.arange(3)).all()
    jy, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    py, _ = pmoe.apply_moe(cfg, p, xt)
    np.testing.assert_allclose(to_np(py), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)


def test_capacity_equals_reference_over_a_grid():
    for T, E, k, cf in itertools.product(
            (1, 7, 8, 64, 128, 4096), (4, 40, 128), (1, 2, 8),
            (0.5, 1.0, 1.25, 16.0)):
        jcfg = jsmoke(jget("qwen3-moe-235b-a22b")).replace(
            num_experts=E, experts_per_token=k)
        got = pmoe.moe_capacity(T, port_config(jcfg), cf)
        assert got == jmoe.moe_capacity(T, jcfg, cf), (T, E, k, cf)
        assert got % 8 == 0 and got >= 8


def test_granite_capacities_of_the_serve_shapes():
    """granite-moe (E 40, k 8, cf 1.25) at the engine's calls: a decode
    step (B 8), a fused tick's chunk (8 x 16) and a 512-token prefill of 8
    rows, whose mean load per expert (819) stays under C."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-3b-a800m")
    cf = cfg.moe_capacity_factor
    assert [pmoe.moe_capacity(T, cfg, cf) for T in (8, 128, 4096)] == [
        8, 40, 1032]


def test_two_calls_are_bitwise_equal():
    cfg, p, x = _port(*_setup(E=40, k=8, B=2, S=16))
    y1, m1 = pmoe.apply_moe(cfg, p, x, capacity_factor=1.0)
    y2, m2 = pmoe.apply_moe(cfg, p, x, capacity_factor=1.0)
    assert torch.equal(y1, y2)
    assert all(torch.equal(m1[n], m2[n]) for n in m1)


def test_init_draws_the_reference_distributions():
    """Router (D, E) at σ = 1/√D in the param dtype; the (E, ·, ·) expert
    tensors at σ = 1/√E (fan_in = shape[0]) in the compute dtype; all
    truncated at ±2σ."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-3b-a800m").replace(d_ff=64, num_experts=8)
    gen = torch.Generator().manual_seed(0)
    p = pmoe.init_moe(gen, cfg, torch.bfloat16, torch.float32,
                      torch.device("cpu"))
    D, E = cfg.d_model, cfg.num_experts
    assert p["router"].shape == (D, E) and p["router"].dtype == torch.float32
    assert p["wi"].shape == p["wg"].shape == (E, D, 64)
    assert p["wo"].shape == (E, 64, D)
    for n, sd in (("router", D ** -0.5), ("wi", E ** -0.5),
                  ("wo", E ** -0.5)):
        t = p[n].float()
        assert float(t.abs().max()) <= 2 * sd * 1.01
        assert float(t.std()) == pytest.approx(0.88 * sd, rel=0.05)

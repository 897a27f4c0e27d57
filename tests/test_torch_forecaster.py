"""The port's LSTM forecaster against the reference's, on the CPU.

Mirrors of the three LSTM cases of ``tests/test_forecaster.py`` (the
paper's 25-unit architecture, learning a constant trace, beating
MovingMax on a diurnal trace); then parity from one state: ``lstm_apply``
and the gradients of its MSE at (3, 600, 1) from the reference's
``lstm_init(PRNGKey(0))`` (within 1e-5 absolute: fp32 sums in other
orders over 600 steps), and ``train_lstm_forecaster`` from the reference's
initial params (the port's ``lstm_init`` monkeypatched) with the same
numpy batch indices: the first 20 losses within 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread limit)
from repro.core import forecaster as jf
from repro_torch.bridge import lstm_params_from_jax
from repro_torch.core import forecaster as pf
from repro_torch.core.forecaster import (LSTMForecaster, MovingMaxForecaster,
                                         forecast_mae, lstm_apply, lstm_init,
                                         train_lstm_forecaster)
from repro_torch.data.traces import synthetic_twitter_trace
from repro_torch.train.optimizer import value_and_grad

FWD_ATOL = 1e-5
LOSS_RTOL = 1e-4


# ---------------------------------------------- tests/test_forecaster.py
def test_lstm_paper_architecture():
    """25-unit LSTM + 1-unit dense (paper §5)."""
    p = lstm_init(torch.Generator().manual_seed(0), hidden=25)
    assert p["wh"].shape == (25, 100)
    assert p["dense_w"].shape == (25, 1)
    out = lstm_apply(p, torch.ones((3, 50, 1)))
    assert out.shape == (3,)


def test_lstm_learns_constant_trace():
    trace = np.full(4000, 30.0, np.float32)
    fc, losses = train_lstm_forecaster(trace, steps=80, batch=16,
                                       device="cpu")
    assert losses[-1] < losses[0]
    pred = fc.predict(trace[:2000])
    assert 15.0 < pred < 45.0


def test_lstm_beats_moving_max_on_diurnal():
    trace = synthetic_twitter_trace(seconds=3 * 3600, seed=5)
    fc, _ = train_lstm_forecaster(trace[:2 * 3600], steps=150, batch=32,
                                  device="cpu")
    test = trace[2 * 3600:]
    lstm = forecast_mae(fc, test, stride=400)
    mm = forecast_mae(MovingMaxForecaster(), test, stride=400)
    assert lstm["mae"] < mm["mae"]


# ---------------------------------------------- parity with the reference
def _ref_params():
    return jf.lstm_init(jax.random.PRNGKey(0))


def test_lstm_init_draws_the_reference_distribution():
    """Same shapes, zero biases, normals of σ = 1/√hidden (over the
    (25, 100) recurrent matrix: std within 15% of 0.2)."""
    p = lstm_init(torch.Generator().manual_seed(3))
    ref = _ref_params()
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert float(p["b"].abs().sum()) == 0.0
    assert float(p["dense_b"].abs().sum()) == 0.0
    assert abs(float(p["wh"].std()) - 0.2) < 0.03


def test_lstm_apply_and_its_gradients_match_reference():
    jp = _ref_params()
    pp = lstm_params_from_jax(jp, "cpu")
    rng = np.random.default_rng(1)
    x = rng.random((3, 600, 1)).astype(np.float32)
    y = rng.random(3).astype(np.float32)
    np.testing.assert_allclose(lstm_apply(pp, torch.tensor(x)).numpy(),
                               np.asarray(jf.lstm_apply(jp, jnp.asarray(x))),
                               rtol=0, atol=FWD_ATOL)

    def jloss(p):
        return jnp.mean(jnp.square(jf.lstm_apply(p, jnp.asarray(x)) - y))

    def ploss(p):
        pred = lstm_apply(p, torch.tensor(x))
        return torch.mean(torch.square(pred - torch.tensor(y))), {}

    jl, jg = jax.value_and_grad(jloss)(jp)
    (pl, _), pg = value_and_grad(ploss, pp)
    assert abs(float(pl) - float(jl)) <= FWD_ATOL
    for k in jg:
        np.testing.assert_allclose(pg[k].numpy(), np.asarray(jg[k]), rtol=0,
                                   atol=FWD_ATOL, err_msg=k)


def test_training_losses_match_reference(monkeypatch):
    """The reference's initial params in both; the same numpy draws pick
    the batches, so the two runs see the same windows."""
    trace = synthetic_twitter_trace(seconds=3 * 3600, seed=5)[:2 * 3600]
    _, want = jf.train_lstm_forecaster(trace, steps=20, batch=32)
    monkeypatch.setattr(pf, "lstm_init", lambda gen, hidden=25:
                        lstm_params_from_jax(_ref_params(), "cpu"))
    fc, got = pf.train_lstm_forecaster(trace, steps=20, batch=32,
                                       device="cpu")
    assert len(got) == 20
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert isinstance(fc, LSTMForecaster) and fc.params["wh"].device.type \
        == "cpu"


def test_predict_matches_reference():
    """``LSTMForecaster.predict`` on one trace: the same window, padding
    and scale as the reference's."""
    jp = _ref_params()
    ref = jf.LSTMForecaster(params=jp, scale=90.0)
    port = LSTMForecaster(params=lstm_params_from_jax(jp, "cpu"), scale=90.0)
    trace = synthetic_twitter_trace(seconds=1200, seed=3)
    for n in (30, 600, 1200):          # padded, exact and trailing windows
        assert port.predict(trace[:n]) == pytest.approx(
            ref.predict(trace[:n]), rel=1e-5, abs=1e-4)


def test_one_seed_one_init_on_every_device():
    """The initial params come from a CPU generator of the seed: the
    first loss depends on the seed only (here: two runs of one seed agree
    bitwise, two seeds differ)."""
    trace = synthetic_twitter_trace(seconds=1800, seed=4)
    runs = [train_lstm_forecaster(trace, steps=1, batch=8, seed=s,
                                  device="cpu")[1] for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_training_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lstm_forecaster(np.ones(800, np.float32), steps=1)

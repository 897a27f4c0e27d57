"""Train the paper's LSTM load forecaster (25-unit LSTM + dense, Adam, MSE)
on a synthetic Twitter-like trace, and compare against baselines: the
counterpart of the reference's ``examples/train_forecaster.py``, with its
defaults and its output. Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_forecaster [--steps 300]
"""
import argparse

from repro_torch.core.forecaster import (EnsembleMaxForecaster,
                                         MovingMaxForecaster, forecast_mae,
                                         train_lstm_forecaster)
from repro_torch.data.traces import synthetic_twitter_trace
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hours", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    trace = synthetic_twitter_trace(seconds=args.hours * 3600, seed=2)
    split = int(len(trace) * 0.75)
    print(f"trace: {len(trace)}s, train {split}s / test {len(trace)-split}s")

    fc, losses = train_lstm_forecaster(trace[:split], steps=args.steps,
                                       device=dev)
    print(f"LSTM trained: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    test = trace[split:]
    rows = {
        "LSTM (paper)": fc,
        "MovingMax": MovingMaxForecaster(),
        "Ensemble(max)": EnsembleMaxForecaster(members=(fc, MovingMaxForecaster())),
    }
    print(f"\n{'forecaster':<16} {'MAE':>8} {'under-predict rate':>20}")
    for name, f in rows.items():
        m = forecast_mae(f, test, stride=240)
        print(f"{name:<16} {m['mae']:8.2f} {m['under_rate']:20.2%}")
    print("\n(under-predictions are what cause SLO violations; the ensemble "
          "trades MAE for safety)")


if __name__ == "__main__":
    main()

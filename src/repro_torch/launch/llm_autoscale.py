"""InfAdapter on an LLM variant ladder, with H100 cards as resource units:
the counterpart of the reference's ``examples/llm_autoscale_tpu.py``.

Each rung of a depth-scaled ladder of the architecture gets a throughput
profile from the analytic roofline of one NVIDIA H100 SXM
(``repro_torch.core.profiles.roofline_profile``: 989 TFLOP/s dense bf16,
3.35 TB/s HBM a card); the same exact-DP solver and simulator then run the
20-minute bursty trace, scaled to the ladder's capacity. Host only: the
profiles are analytic and nothing runs on a card. The default
architecture is yi-6b, as in the reference example.

Run:  PYTHONPATH=src python -m repro_torch.launch.llm_autoscale
          [--arch yi-6b] [--budget 12] [--slo-ms 2000]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.adapter import (ControllerConfig, InfAdapterController,
                                      MSPlusController)
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import variant_ladder_profiles
from repro_torch.data.traces import paper_bursty_trace
from repro_torch.sim.runner import run_experiment


def main(argv=None, log=print) -> dict:
    """Print the ladder and the InfAdapter / MS+ results; returns name ->
    ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--budget", type=int, default=12, help="H100 cards")
    ap.add_argument("--slo-ms", type=float, default=2000.0)
    args = ap.parse_args(argv)

    base = get_config(args.arch)
    profiles = variant_ladder_profiles(base)
    log(f"variant ladder for {args.arch} (H100 cards as units):")
    for name, p in profiles.items():
        log(f"  {name:24s} acc~{p.accuracy:5.2f} th(4 cards)="
            f"{p.throughput(4):7.1f} rps  load={p.rt:5.1f}s")

    best = max(p.accuracy for p in profiles.values())
    # scale the trace to this ladder's capacity regime
    cap4 = min(p.throughput(4) for p in profiles.values())
    trace = paper_bursty_trace(base=cap4 * 2.0, spike=cap4 * 4.5)
    warm = {max(profiles, key=lambda m: profiles[m].th_slope): 4}

    cfg = ControllerConfig(budget=args.budget, slo_ms=args.slo_ms,
                           beta=0.02, gamma=0.05)
    out = {}
    for name, ctrl in [
        ("InfAdapter", InfAdapterController(profiles, MovingMaxForecaster(),
                                            cfg)),
        ("MS+", MSPlusController(profiles, MovingMaxForecaster(), cfg)),
    ]:
        r = run_experiment(name, ctrl, profiles, trace, slo_ms=args.slo_ms,
                           warm_start=warm, reference_accuracy=best)
        s = r.summary
        log(f"{name:12s} viol={s['violation_rate']:6.2%} "
            f"acc_loss={s['accuracy_loss']:5.2f} "
            f"cost={s['avg_cost_units']:5.1f} H100 cards")
        out[name] = r
    return out


if __name__ == "__main__":
    main()

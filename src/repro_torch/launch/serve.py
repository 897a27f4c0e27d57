"""Serving launcher: the InfAdapter control loop over the port's engine,
with attention on the CUDA kernels.

Two ladders of one architecture: the smoke form (``build_ladder``'s
default, identical to the reference's ``repro.launch.serve.build_ladder``)
and the full-width form (``full_width=True``: published widths, depths
8/15/22 — for tinyllama-1.1b the 22-layer rung is the published model, in
bf16). Runs on ``cuda`` unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width --seconds 30
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import VariantProfile
from repro_torch.serving.driver import rise_fall_load, run_serving_loop
from repro_torch.serving.engine import InProcessServingEngine

SMOKE_DEPTHS = (2, 4, 6)
FULL_DEPTHS = (8, 15, 22)
LADDER_ACCS = (70.0, 75.0, 78.0)

# engine geometry and request shape of each form: smoke is the reference
# launcher's; full width serves 512-token prompts from the full vocab
GEOMETRY = {
    False: dict(max_batch=8, prompt_len=16, max_new=8, decode_chunk=4),
    True: dict(max_batch=8, prompt_len=512, max_new=64, decode_chunk=8),
}
# offered load (lo, hi req/s of rise_fall_load): the reference launcher's
# for smoke; for full width, within what one H100 sustains at this geometry
LOAD = {False: (4.0, 32.0), True: (0.5, 2.5)}


def build_ladder(arch: str, depths=None, accs=LADDER_ACCS,
                 full_width: bool = False):
    """name -> (config, proxy accuracy). Smoke: the reference's d_model=128
    fp32 ladder at depths 2/4/6. Full width: the published config at depths
    8/15/22, bf16 compute."""
    if full_width:
        base = get_config(arch)
        depths = depths or FULL_DEPTHS
    else:
        base = smoke_variant(get_config(arch)).replace(d_model=128)
        depths = depths or SMOKE_DEPTHS
    return {
        f"{arch}-L{d}": (base.replace(num_layers=d, name=f"{arch}-L{d}"), a)
        for d, a in zip(depths, accs)
    }


def calibrate(engine, variants, reps=3, max_new=8):
    """Measured profile per variant: load it alone, time ``reps`` pump
    batches of ``max_new`` tokens — the engine's request budget, so the
    profile describes the requests it serves (the result's host copy ends
    each timed batch, so the device work is inside the clock)."""
    profiles = {}
    for name in variants:
        engine.apply_allocation(0.0, {name: 1})
        b = engine.backends[name]
        prompts = np.ones((b.max_batch, b.prompt_len), np.int64)
        t0 = time.time()
        for _ in range(reps):
            b.generate(prompts, max_new=max_new)
        per_req = (time.time() - t0) / (reps * b.max_batch)
        profiles[name] = VariantProfile(
            name=name, accuracy=variants[name][1], rt=b.readiness_s,
            th_slope=1.0 / per_req, th_intercept=0.0,
            lat_base_ms=per_req * 1000,
            lat_k_ms=per_req * 1000 * b.max_batch, max_units=4)
    engine.apply_allocation(0.0, {})
    return profiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--interval", type=float, default=6.0)
    ap.add_argument("--budget", type=int, default=3)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--slo-ms", type=float, default=2000.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    args = ap.parse_args(argv)

    variants = build_ladder(args.arch, full_width=args.full_width)
    geo = GEOMETRY[args.full_width]
    engine = InProcessServingEngine(variants, use_kernels=True,
                                    device=args.device, **geo)
    print("calibrating variants...")
    profiles = calibrate(engine, variants, max_new=geo["max_new"])
    for n, p in profiles.items():
        print(f"  {n}: {p.th_slope:.1f} rps/unit, rt {p.rt:.2f}s")

    cfg = ControllerConfig(interval_s=args.interval, budget=args.budget,
                           slo_ms=args.slo_ms, beta=args.beta, gamma=0.05,
                           reactive=True, queue_aware=True)
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(window=10), cfg)
    vocab = variants[next(iter(variants))][0].vocab_size
    run_serving_loop(engine, ctrl, seconds=args.seconds,
                     interval=args.interval,
                     load_fn=rise_fall_load(max(args.seconds, 1),
                                            *LOAD[args.full_width]),
                     prompt_len=geo["prompt_len"], max_new=geo["max_new"],
                     vocab=vocab if args.full_width else 256)
    s = engine.summarize(args.slo_ms,
                         max(p.accuracy for p in profiles.values()))
    if not s:
        print(f"\nno requests completed ({engine.rejected} rejected)")
        return
    print(f"\n{s['n_requests']} requests: viol={s['violation_rate']:.1%} "
          f"p99={s['p99_ms']:.0f}ms acc_loss={s['accuracy_loss']:.2f}%")


if __name__ == "__main__":
    main()

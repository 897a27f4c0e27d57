"""Serving launcher: the InfAdapter control loop over the port's engine,
with attention on the CUDA kernels.

Two ladders of one architecture: the smoke form (``build_ladder``'s
default, identical to the reference's ``repro.launch.serve.build_ladder``)
and the full-width form (``full_width=True``: published widths, depths per
architecture in ``FULL_DEPTHS`` — tinyllama-1.1b 8/15/22, mamba2-130m
8/16/24, the deepest rung being the published model — in bf16). Runs on
``cuda`` unless ``--device cpu``.

With ``--kv-cache paged`` the loop serves on the paged KV pool
(``--prefix-sharing`` adds the prefix index). ``--scheduler``
(fifo|edf|chunked|chunked-fifo), ``--preemption``
(none|requeue|drop|migrate) and ``--async-tick`` (the two-phase
dispatch/commit tick) set the serving engine's scheduling, as the
reference's ``examples/serve_autoscale.py`` exposes them; requests then
carry the ``--slo-ms`` deadline the schedulers read, on the loop's elapsed
clock. ``--speculative DRAFTER:VERIFIER`` (with ``--spec-k``) serves the
verifier rung through speculative rounds drafted by the drafter rung. The profiles always come from the pump path of a plain dense engine
of the same ladder and geometry (the paged backend has none).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --full-width --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-cache paged \
      --prefix-sharing --device cpu --seconds 5
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
      --scheduler chunked --preemption requeue --async-tick --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
      --speculative tinyllama-1.1b-L8:tinyllama-1.1b-L22 --seconds 30
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import VariantProfile
from repro_torch.serving.driver import (ElapsedClock, rise_fall_load,
                                        run_serving_loop)
from repro_torch.serving.engine import InProcessServingEngine

SMOKE_DEPTHS = (2, 4, 6)
# full-width depths of each servable architecture (last = published depth)
FULL_DEPTHS = {"tinyllama-1.1b": (8, 15, 22), "mamba2-130m": (8, 16, 24)}
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
    fp32 ladder at depths 2/4/6. Full width: the published config at its
    ``FULL_DEPTHS``, bf16 compute."""
    if full_width:
        base = get_config(arch)
        if depths is None and arch not in FULL_DEPTHS:
            raise ValueError(f"no full-width ladder for {arch!r}; have "
                             f"{sorted(FULL_DEPTHS)}")
        depths = depths or FULL_DEPTHS[arch]
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
    ap.add_argument("--kv-cache", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--prefix-sharing", action="store_true")
    ap.add_argument("--scheduler", default="fifo",
                    choices=("fifo", "edf", "chunked", "chunked-fifo"),
                    help="queue-to-slot scheduling discipline")
    ap.add_argument("--preemption", default="none",
                    choices=("none", "requeue", "drop", "migrate"),
                    help="retire deadline-hopeless residents for feasible "
                         "waiters (requeue resumes them with their tokens; "
                         "migrate resumes them on a cheaper variant)")
    ap.add_argument("--async-tick", action="store_true",
                    help="two-phase dispatch/commit tick: each tick "
                         "dispatches its step before committing the "
                         "previous tick's tokens (greedy outputs equal "
                         "the sync tick's)")
    ap.add_argument("--speculative", default=None,
                    metavar="DRAFTER:VERIFIER",
                    help="speculative decoding on the ladder: the drafter "
                         "rung proposes --spec-k tokens a round, the "
                         "verifier scores them in one step (greedy outputs "
                         "stay the verifier's own)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length per speculative round")
    args = ap.parse_args(argv)

    variants = build_ladder(args.arch, full_width=args.full_width)
    geo = GEOMETRY[args.full_width]
    engine = InProcessServingEngine(variants, use_kernels=True,
                                    device=args.device, **geo)
    print("calibrating variants...")
    profiles = calibrate(engine, variants, max_new=geo["max_new"])
    # calibrated on the plain dense engine, served on the configured one
    engine = InProcessServingEngine(
        variants, use_kernels=True, device=args.device, clock=ElapsedClock(),
        kv_cache=args.kv_cache, kv_prefix_sharing=args.prefix_sharing,
        scheduler=args.scheduler, preemption=args.preemption,
        async_tick=args.async_tick, speculative=args.speculative,
        spec_k=args.spec_k, **geo)
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
                     vocab=vocab if args.full_width else 256,
                     slo_ms=args.slo_ms)
    s = engine.summarize(args.slo_ms,
                         max(p.accuracy for p in profiles.values()))
    if not s:
        print(f"\nno requests completed ({engine.rejected} rejected)")
        return
    print(f"\n{s['n_requests']} requests: viol={s['violation_rate']:.1%} "
          f"p99={s['p99_ms']:.0f}ms acc_loss={s['accuracy_loss']:.2f}%")
    if "spec_accept_rate" in s:
        print(f"speculative: accept rate {s['spec_accept_rate']:.3f}, "
              f"tokens per verifier step {s['spec_tokens_per_step']:.3f}")


if __name__ == "__main__":
    main()

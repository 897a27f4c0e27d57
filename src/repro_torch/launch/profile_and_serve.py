"""Measured profiling end to end on the port's engine (the paper's §5
Profiler, live), the counterpart of the reference's
``examples/profile_and_serve.py``:

  1. PROFILE   — sweep the ladder on the engine across the paper's
                 allocation points (1, 2, 4, 8 slots); regression-fit
                 th(n) = a·n + b and p(n) = base + k/n from measurements.
  2. PERSIST   — register everything in the versioned profile store,
                 together with a cross-calibrated H100 roofline profile for
                 the published tinyllama-1.1b (``profile_unrunnable``);
                 save, reload, and serve from the *loaded* store.
  3. SERVE     — run the InfAdapter control loop against the engine using
                 the measured profiles (units -> concurrency enforced, so
                 profiled capacity is live capacity).
  4. DRIFT     — slow the engine down (decode chunk cut to 1 token plus a
                 host stall ahead of every decode chunk, in
                 ``VariantBackend._dispatch_chunk``, as under host
                 contention) and serve again: the drift detector flags the
                 stale profiles.
  5. RECAL     — targeted re-profile of only the drifted variants; the
                 store is patched, the controller's profiles swapped, and
                 the Eq. 1 solver's allocation shifts.

Sizes: the smoke ladder (``launch.serve.build_ladder``: d_model 128, depths
2/4/6, fp32) at the smoke geometry by default; ``--full-width`` profiles
tinyllama-1.1b at d_model 2048 on the 8/15/22-layer ladder in bf16 at the
full-width geometry (512-token prompts, 64 new tokens, decode chunk 8),
kernels on, every step replayed as a CUDA graph. Runs on ``cuda`` unless
``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_and_serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.profile_and_serve \
      --full-width --seconds 20
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.launch.serve import GEOMETRY, LOAD, build_ladder
from repro_torch.profiling.calibrate import profile_unrunnable
from repro_torch.profiling.drift import DriftDetector, OnlineRecalibrator
from repro_torch.profiling.measure import EngineProfiler
from repro_torch.profiling.store import DEFAULT_STORE_DIR, ProfileStore
from repro_torch.serving.api import Request
from repro_torch.serving.driver import rise_fall_load, run_serving_loop
from repro_torch.serving.engine import InProcessServingEngine

# SLO of the serve stage per form: the smoke form's is the reference
# example's; a full-width request spends ~0.4 s on the L22 rung
SLO_MS = {False: 2000.0, True: 5000.0}
# host stall ahead of every decode chunk in the drift stage, seconds
STALL_S = 0.010


def make_engine(variants, geo, device, decode_chunk=None):
    return InProcessServingEngine(
        variants, use_kernels=True, device=device, enforce_units=True,
        **dict(geo, decode_chunk=decode_chunk or geo["decode_chunk"]))


def stall_decode_chunks(backend, stall_s: float) -> None:
    """Inject drift: the host stalls ahead of every decode chunk's replay,
    as under a noisy neighbour stealing the CPU."""
    orig = backend._dispatch_chunk

    def stalled():
        time.sleep(stall_s)
        return orig()
    backend._dispatch_chunk = stalled


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--seconds", type=int, default=12)
    ap.add_argument("--interval", type=float, default=4.0)
    ap.add_argument("--store", default=os.path.join(DEFAULT_STORE_DIR,
                                                    "torch_demo.json"),
                    help="where the profile store is saved")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Run the five stages; returns the measurements, the store's path and
    the allocations before and after recalibration."""
    args = parse_args(argv)
    fw = args.full_width
    variants = build_ladder("tinyllama-1.1b", full_width=fw)
    geo = GEOMETRY[fw]
    vocab = next(iter(variants.values()))[0].vocab_size if fw else 256
    engine = make_engine(variants, geo, args.device)

    # -- 1. PROFILE: measured sweep over the paper's allocation points -------
    log("== profiling variants from engine measurements ==")
    profiler = EngineProfiler(engine, points=(1, 2, 4, 8),
                              requests_per_point=16, warmup=4, vocab=vocab)
    store = ProfileStore(args.store)
    measurements = profiler.profile_all(store=store)
    for name, m in measurements.items():
        log(f"  {name}: th(n)={m.th_fit.slope:.2f}n{m.th_fit.intercept:+.2f} "
            f"rps (R2={m.th_fit.r_squared:.3f})  "
            f"p(n)={m.lat_base_ms:.1f}+{m.lat_k_ms:.1f}/n ms "
            f"(R2={m.lat_r_squared:.3f})  rt={m.readiness_s:.2f}s")

    # -- 2. PERSIST: + cross-calibrated roofline for the published model -----
    big = get_config("tinyllama-1.1b").replace(name="tinyllama-1.1b-roofline")
    profile_unrunnable([big], [82.0], measurements,
                       {n: variants[n][0] for n in variants}, store=store,
                       tokens_per_request=geo["max_new"])
    path = store.save()
    loaded = ProfileStore.load(path)
    log(f"== store saved+reloaded: {path} ({len(loaded)} profiles) ==")
    for n in loaded.names():
        e = loaded.entry(n)
        log(f"  {n}: provenance={e.provenance}")

    # -- 3. SERVE with MEASURED profiles (not inline constants) --------------
    slo_ms = SLO_MS[fw]
    measured = {n: loaded.get(n) for n in variants}   # engine-servable subset
    cfg = ControllerConfig(interval_s=args.interval, budget=8, slo_ms=slo_ms,
                           beta=0.05, gamma=0.05, queue_aware=True)
    ctrl = InfAdapterController(measured, MovingMaxForecaster(window=10), cfg)
    log(f"\n== serving {args.seconds}s with measured profiles ==")
    lo, hi = LOAD[fw]
    run_serving_loop(engine, ctrl, seconds=args.seconds,
                     interval=args.interval,
                     load_fn=rise_fall_load(max(args.seconds, 1), lo, hi),
                     prompt_len=geo["prompt_len"], max_new=geo["max_new"],
                     vocab=vocab, log=log)
    s = engine.summarize(slo_ms, best_accuracy=max(
        a for _, a in variants.values()))
    if s:
        log(f"served {s['n_requests']}: viol={s['violation_rate']:.1%} "
            f"p99={s['p99_ms']:.0f}ms queue~{s.get('mean_queue_ms', 0):.0f}ms "
            f"service~{s.get('mean_service_ms', 0):.0f}ms")
    last = ctrl.decisions[-1].allocation.units if ctrl.decisions else {}
    units = ({m: n for m, n in last.items() if n > 0}
             or {next(iter(variants)): 2})
    engine.apply_allocation(0.0, {})     # retire the serve stage's loads

    # -- 4. DRIFT: cut the decode chunk + simulate host contention -----------
    log(f"\n== injecting slowdown (decode_chunk {geo['decode_chunk']} -> 1, "
        f"+{STALL_S * 1e3:.0f}ms host stall per chunk) ==")
    slow = make_engine(variants, geo, args.device, decode_chunk=1)
    detector = DriftDetector(loaded, tolerance=0.35, min_requests=8)
    slow.apply_allocation(0.0, units)
    for b in slow.backends.values():
        stall_decode_chunks(b, STALL_S)
    rng = np.random.default_rng(0)
    for i in range(24):
        name = list(units)[i % len(units)]
        slow.submit(Request(rid=i, tokens=rng.integers(
            0, vocab, geo["prompt_len"]).astype(np.int64),
            max_new=geo["max_new"], arrival=time.time()), name)
        slow.step(0.0)
    slow.drain(0.0)
    detector.observe_engine(slow)
    reports = detector.check_all(units)
    for rep in reports:
        flag = "DRIFTED" if rep.drifted else "ok"
        log(f"  {rep.variant}: {flag} service_ratio={rep.service_ratio:.2f} "
            f"({rep.reason or 'within band'})")

    # -- 5. RECAL: re-profile drifted variants, allocation shifts ------------
    slow_profiler = EngineProfiler(slow, points=(1, 2, 4),
                                   requests_per_point=10, warmup=3,
                                   vocab=vocab)
    recal = OnlineRecalibrator(slow_profiler, loaded, controller=ctrl,
                               detector=detector)
    drifted = [r.variant for r in reports if r.drifted]
    lam = ctrl.decisions[-1].predicted_load if ctrl.decisions else 16.0
    before = ctrl.decide(0.0, slow).allocation.units
    for name in drifted:
        m = recal.recalibrate(name)
        log(f"  recalibrated {name}: th(1) "
            f"{measured[name].throughput(1):.2f} -> "
            f"{m.profile.throughput(1):.2f} rps")
    after = ctrl.decide(0.0, slow).allocation.units
    log(f"\n== allocation for lam={lam:.1f} rps: {before} -> {after} ==")
    loaded.save()
    log(f"store updated: {path}")
    return dict(measurements=measurements, store=path, reports=reports,
                drifted=drifted, before=before, after=after)


if __name__ == "__main__":
    main()

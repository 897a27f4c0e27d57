"""Replay the paper's 20-minute evaluation (Fig. 5/7/8) in simulation, the
counterpart of the reference's ``examples/replay_twitter_trace.py``.

Compares InfAdapter vs MS+ vs VPA+{ResNet18,50,152} on the bursty and
non-bursty traces, printing the accuracy-loss / cost / P99 panels the paper
plots, plus the beyond-paper reactive+queue-aware InfAdapter. The panels are
host only (``repro_torch.sim``) and print the reference example's text.

``--engine`` additionally replays a scaled slice of the bursty trace
against the port's ``InProcessServingEngine`` through the same control
loop (``run_serving_loop`` + ``trace_load``): the trace drives real
execution on the card, not just the DES. The ladder is the smoke form of
``launch.serve.build_ladder`` (d_model 128, 2 and 4 layers, fp32) unless
``--full-width`` takes the published-width ladder (``FULL_DEPTHS``,
``GEOMETRY[True]``: 512-token prompts, 64 new tokens, bf16), kernels on,
every step replayed as a CUDA graph. The profiles come from an
``EngineProfiler`` sweep of the engine, or from the store that
``launch.profile_and_serve`` saved (``--store PATH``). ``--scheduler``
picks the engine's scheduling discipline. The engine runs on ``cuda``
unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.replay_trace [--beta 0.05]
          [--engine --engine-seconds 20 --scheduler chunked]
          [--full-width] [--store PATH] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.adapter import (ControllerConfig, InfAdapterController,
                                      MSPlusController, VPAPlusController)
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import paper_resnet_profiles
from repro_torch.data.traces import paper_bursty_trace, paper_nonbursty_trace
from repro_torch.device import resolve_device
from repro_torch.sim.runner import run_experiment

REF_ACC = 78.31  # ResNet152 (most accurate variant)
ENGINE_SLO_MS = 2000.0
SMOKE_DEPTHS = (2, 4)


def engine_ladder(full_width: bool):
    """The engine replay's ladder: the reference example's two smoke rungs
    (named as ``launch.serve`` names them, so a store saved by
    ``launch.profile_and_serve`` serves them), or the full-width ladder."""
    from repro_torch.launch.serve import build_ladder
    if full_width:
        return build_ladder("tinyllama-1.1b", full_width=True)
    return build_ladder("tinyllama-1.1b", depths=SMOKE_DEPTHS)


def stored_profiles(path: str, names) -> dict:
    """The ladder's profiles from a saved ``ProfileStore``."""
    from repro_torch.profiling.store import ProfileStore
    store = ProfileStore.load(path)
    missing = [n for n in names if n not in store.names()]
    if missing:
        raise KeyError(f"{path} holds no profile of {missing}; it has "
                       f"{store.names()}")
    return {n: store.get(n) for n in names}


def replay_on_engine(seconds: float, scheduler: str, scale: float, *,
                     device: str = "cuda", full_width: bool = False,
                     store: str = None, profiles=None, log=print) -> dict:
    """Drive the port's engine with the recorded bursty trace: profile the
    ladder live (unless ``store`` or ``profiles`` give them), then replay
    ``trace_load(paper_bursty_trace())`` (rate scaled by ``scale``) behind
    the InfAdapter loop. Returns the run's ``engine``, ``summary`` (None
    when no request completed), ``submitted`` and ``controller``."""
    from repro_torch.launch.serve import GEOMETRY
    from repro_torch.profiling.measure import EngineProfiler
    from repro_torch.serving.driver import (ElapsedClock, run_serving_loop,
                                            trace_load)
    from repro_torch.serving.engine import InProcessServingEngine

    variants = engine_ladder(full_width)
    geo = GEOMETRY[full_width]
    vocab = next(iter(variants.values()))[0].vocab_size if full_width \
        else 256
    engine = InProcessServingEngine(
        variants, use_kernels=True, device=device, scheduler=scheduler,
        clock=ElapsedClock(), **geo)
    if profiles is None and store is not None:
        profiles = stored_profiles(store, variants)
    if profiles is None:
        profiler = EngineProfiler(engine, points=(1, 2), requests_per_point=8,
                                  warmup=2, max_units=3, vocab=vocab)
        profiles = {m.profile.name: m.profile
                    for m in profiler.profile_all().values()}
    profiles = {n: profiles[n] for n in variants}
    cfg = ControllerConfig(interval_s=5.0, budget=3, slo_ms=ENGINE_SLO_MS,
                           beta=0.05, gamma=0.05, reactive=True,
                           queue_aware=True)
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(window=10), cfg)
    # the paper trace peaks near 95 rps; scale it into the ladder's range
    load_fn = trace_load(paper_bursty_trace(), scale=scale)
    log(f"\nreplaying bursty trace on the port's engine for {seconds:.0f}s "
        f"(scheduler={scheduler}, rate scale {scale}, device {device})...")
    n = run_serving_loop(engine, ctrl, seconds=seconds, interval=5.0,
                         load_fn=load_fn, slo_ms=ENGINE_SLO_MS,
                         prompt_len=geo["prompt_len"],
                         max_new=geo["max_new"], vocab=vocab, log=log)
    best = max(a for _, a in variants.values())
    s = engine.summarize(ENGINE_SLO_MS, best_accuracy=best)
    if not s:
        log(f"no requests completed ({engine.rejected} rejected)")
    else:
        log(f"engine replay: {s['n_requests']}/{n} served  "
            f"goodput={s['goodput']:.1%} viol={s['violation_rate']:.1%} "
            f"p99={s['p99_ms']:.0f}ms queue_p99={s.get('p99_queue_ms', 0):.0f}ms")
    return dict(engine=engine, summary=s or None, submitted=n,
                controller=ctrl)


def simulated_panels(beta: float, budget: int, log=print) -> dict:
    """The paper's panels on ``SimCluster``: trace name -> results."""
    profiles = paper_resnet_profiles()
    out = {}
    for tname, trace in [("bursty (Fig.5)", paper_bursty_trace()),
                         ("non-bursty (Fig.8)", paper_nonbursty_trace())]:
        log(f"\n=== {tname}, beta={beta} ===")
        log(f"{'method':<22} {'viol%':>7} {'p99 ms':>8} {'acc loss':>9} "
            f"{'cost':>6}")
        rows = []
        cfg = ControllerConfig(budget=budget, beta=beta, gamma=0.2)
        c = InfAdapterController(profiles, MovingMaxForecaster(), cfg)
        rows.append(run_experiment("InfAdapter", c, profiles, trace,
                                   warm_start={"resnet18": 8},
                                   reference_accuracy=REF_ACC))
        cfg_r = ControllerConfig(budget=budget, beta=beta, gamma=0.2,
                                 reactive=True, queue_aware=True)
        c = InfAdapterController(profiles, MovingMaxForecaster(), cfg_r)
        rows.append(run_experiment("InfAdapter-reactive*", c, profiles, trace,
                                   warm_start={"resnet18": 8},
                                   reference_accuracy=REF_ACC))
        c = MSPlusController(profiles, MovingMaxForecaster(), cfg)
        rows.append(run_experiment("MS+", c, profiles, trace,
                                   warm_start={"resnet18": 8},
                                   reference_accuracy=REF_ACC))
        for v in ("resnet18", "resnet50", "resnet152"):
            c = VPAPlusController(profiles[v], cfg)
            rows.append(run_experiment(f"VPA-{v}", c, {v: profiles[v]}, trace,
                                       warm_start={v: 8},
                                       reference_accuracy=REF_ACC))
        for r in rows:
            s = r.summary
            log(f"{r.name:<22} {s['violation_rate']*100:6.2f}% "
                f"{s['p99_ms']:8.0f} {s['accuracy_loss']:8.2f}% "
                f"{s['avg_cost_units']:6.1f}")
        log("(* beyond-paper extension; see EXPERIMENTS.md)")
        out[tname] = rows
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--budget", type=int, default=20)
    ap.add_argument("--engine", action="store_true",
                    help="also replay the bursty trace on the port's engine "
                         "via run_serving_loop + trace_load")
    ap.add_argument("--engine-seconds", type=float, default=20.0)
    ap.add_argument("--engine-scale", type=float, default=0.15,
                    help="trace rate multiplier for the engine replay")
    ap.add_argument("--scheduler", default="chunked",
                    choices=("fifo", "edf", "chunked"),
                    help="engine scheduling discipline (--engine mode)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="replay on the published-width ladder in bf16")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="serve the engine replay on the profiles of this "
                         "saved profile store instead of profiling")
    return ap.parse_args(argv)


def main(argv=None, profiles=None, log=print) -> dict:
    """The simulated panels, then (``--engine``) the engine replay on
    ``profiles`` when given. Returns ``panels`` and ``engine`` (the replay's
    result, None without ``--engine``)."""
    args = parse_args(argv)
    if args.engine:       # no card: fail before the panels, not after them
        resolve_device(args.device)
    out = dict(panels=simulated_panels(args.beta, args.budget, log=log),
               engine=None)
    if args.engine:
        out["engine"] = replay_on_engine(
            args.engine_seconds, args.scheduler, args.engine_scale,
            device=args.device, full_width=args.full_width,
            store=args.store, profiles=profiles, log=log)
    return out


if __name__ == "__main__":
    main()

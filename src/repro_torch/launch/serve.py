"""Serving launcher: the InfAdapter control loop over the port's engine,
with attention on the CUDA kernels.

Two ladders of one architecture: the smoke form (``build_ladder``'s
default, identical to the reference's ``repro.launch.serve.build_ladder``)
and the full-width form (``full_width=True``: published widths, depths per
architecture in ``FULL_DEPTHS`` — tinyllama-1.1b 8/15/22, gemma-2b
6/12/18, yi-6b 8/16/32, granite-moe-3b-a800m 8/16/32, mamba2-130m
8/16/24, the deepest rung being the published model — in bf16;
deepseek-67b has none, its 95 published layers being ~134 GB in bf16, so
it needs explicit ``depths``). Runs on ``cuda`` unless ``--device cpu``.

With ``--kv-cache paged`` the loop serves on the paged KV pool
(``--prefix-sharing`` adds the prefix index). ``--scheduler``
(fifo|edf|chunked|chunked-fifo), ``--preemption``
(none|requeue|drop|migrate) and ``--async-tick`` (the two-phase
dispatch/commit tick) set the serving engine's scheduling, as the
reference's ``examples/serve_autoscale.py`` exposes them; requests then
carry the ``--slo-ms`` deadline the schedulers read, on the loop's elapsed
clock. ``--speculative DRAFTER:VERIFIER`` (with ``--spec-k``) serves the
verifier rung through speculative rounds drafted by the drafter rung. The
profiles always come from the pump path of a plain dense engine of the
same ladder and geometry (the paged backend has none); that engine keeps
its own observability bundle, so calibration traffic never reaches the
serving engine's windows, trace or flight recorder.

Observability, as the reference's ``examples/serve_autoscale.py`` wires
it: ``--trace`` records request spans and per-tick records and writes
``TRACE_engine.json`` (Chrome trace_event JSON: open it in Perfetto),
``METRICS_engine.jsonl`` and ``AUDIT_decisions.jsonl`` under
``--report-dir``; ``--profile-dispatch N`` (with ``--trace``) splits every
Nth tick's exec phase into enqueue, device wait and host sync;
``--burn-rate-alerts`` turns on the rolling windows and the SLO burn-rate
monitor, whose alerts make the controller re-solve at once (reason
``burn_rate``); ``--flight-dir DIR`` arms the flight recorder, which dumps
the recent past as ``FLIGHT_<reason>.json`` into DIR on each alert.
``python -m repro_torch.obs.export --validate-trace ... --validate-metrics
... --assert-zero obs.spans_dropped`` checks the reports.

The replica fabric, as the reference example wires it: ``--replicas N``
and ``--nodes M`` serve every variant as single-unit replicas, each a
whole backend, spread over M nodes of ``max(2, ceil(2 * budget / M))``
units (room for the create-then-remove surge and for re-placement after
a crash), with a budget of ``max(N, 2)`` units; ``--fail-node-at T``
crashes node0 T seconds in and recovers it 8 s later. The crashed
replicas' requests are retried on the survivors, and the controller's next
decision re-places them; with ``--flight-dir`` each fault dumps
``FLIGHT_fault_<kind>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --full-width --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --full-width --kv-cache paged --prefix-sharing --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --full-width --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-cache paged \
      --prefix-sharing --device cpu --seconds 5
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
      --scheduler chunked --preemption requeue --async-tick --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
      --speculative tinyllama-1.1b-L8:tinyllama-1.1b-L22 --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width --trace \
      --profile-dispatch 4 --burn-rate-alerts --flight-dir reports/flight \
      --seconds 30
  PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
      --replicas 4 --nodes 2 --fail-node-at 5 --flight-dir reports/flight \
      --seconds 15
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.cluster import (FaultSchedule, make_nodes, node_crash,
                                 node_recover)
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.adapter import ControllerConfig, InfAdapterController
from repro_torch.core.forecaster import MovingMaxForecaster
from repro_torch.core.profiles import VariantProfile
from repro_torch.obs import (BurnRateRule, CollectingSink, FlightRecorder,
                             FlightTrigger, Observability, SLOMonitor)
from repro_torch.obs.export import (write_audit_jsonl, write_chrome_trace,
                                    write_metrics_jsonl)
from repro_torch.serving.driver import (ElapsedClock, rise_fall_load,
                                        run_serving_loop)
from repro_torch.serving.engine import InProcessServingEngine

SMOKE_DEPTHS = (2, 4, 6)
# full-width depths of each servable architecture (last = published depth)
FULL_DEPTHS = {"tinyllama-1.1b": (8, 15, 22), "gemma-2b": (6, 12, 18),
               "yi-6b": (8, 16, 32), "granite-moe-3b-a800m": (8, 16, 32),
               "mamba2-130m": (8, 16, 24)}
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--interval", type=float, default=6.0)
    ap.add_argument("--budget", type=int, default=3)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--slo-ms", type=float, default=2000.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--load", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="offered load of the rising-falling curve, req/s "
                         "(default: the form's LOAD)")
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
    ap.add_argument("--trace", action="store_true",
                    help="record request spans and per-tick phase costs "
                         "and write TRACE_engine.json (Perfetto-loadable), "
                         "METRICS_engine.jsonl and AUDIT_decisions.jsonl "
                         "under --report-dir")
    ap.add_argument("--report-dir", default="reports",
                    help="where --trace writes its reports")
    ap.add_argument("--profile-dispatch", type=int, default=0, metavar="N",
                    help="with --trace, fence every Nth tick's exec step: "
                         "its record splits exec_ms into dispatch_ms "
                         "(enqueue), device_ms (wait on the device) and "
                         "host_sync_ms")
    ap.add_argument("--burn-rate-alerts", action="store_true",
                    help="turn on rolling windows and the SLO burn-rate "
                         "monitor; the controller re-solves at once when "
                         "the fast and the slow window both burn the error "
                         "budget too fast")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the flight recorder: dump a Perfetto-loadable "
                         "FLIGHT_<reason>.json of the recent past into DIR "
                         "on each burn-rate alert and injected fault")
    ap.add_argument("--replicas", type=int, default=0,
                    help="shard variants into single-unit replicas across "
                         "the node set (0 = one backend per variant)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="node count for the replica fabric "
                         "(default: max(--replicas, 2))")
    ap.add_argument("--fail-node-at", type=float, default=None,
                    help="crash node0 this many seconds in (it recovers 8 s "
                         "later): exercises retry and re-placement")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, profiles=None, log=print) -> dict:
    """Calibrate (unless ``profiles`` are given: they must come from a plain
    dense engine of the same ladder and geometry), then serve for
    ``args.seconds`` under the InfAdapter controller with the engine and
    observability options of ``args``. Returns the run's ``engine``, its
    ``summary`` (None when no request completed), ``slo_monitor`` and
    ``flight`` (None when off), ``burn_resolves`` (the controller's
    re-solves for an alert), ``reports`` (name -> path of each report
    written), ``faults`` (the fault schedule, None without
    ``--fail-node-at``) and ``controller``."""
    variants = build_ladder(args.arch, full_width=args.full_width)
    geo = GEOMETRY[args.full_width]
    if profiles is None:
        engine = InProcessServingEngine(variants, use_kernels=True,
                                        device=args.device, **geo)
        log("calibrating variants...")
        profiles = calibrate(engine, variants, max_new=geo["max_new"])
        del engine
    # the serving engine's observability: the rolling windows feed the
    # burn-rate monitor; the flight recorder rides the tracer's hooks
    obs, flight = None, None
    if args.burn_rate_alerts or args.flight_dir:
        if args.flight_dir:
            os.makedirs(args.flight_dir, exist_ok=True)
            flight = FlightRecorder(out_dir=args.flight_dir)
        obs = Observability(trace=args.trace, windows=True, flight=flight)
    fabric_on = (args.replicas > 0 or args.nodes > 0
                 or args.fail_node_at is not None)
    budget = max(args.replicas, 2) if fabric_on else args.budget
    fabric_kw = {}
    if fabric_on:
        n_nodes = args.nodes or max(args.replicas, 2)
        # room for the create-then-remove surge and for re-placement after
        # a node crash
        node_cap = max(2, -(-2 * budget // n_nodes))
        log(f"cluster fabric: {n_nodes} nodes x {node_cap} units, "
            f"replica_size=1 (budget {budget})")
        fabric_kw = dict(nodes=make_nodes(n_nodes, node_cap),
                         placement="spread", replica_size=1)
    # calibrated on the plain dense engine, served on the configured one
    engine = InProcessServingEngine(
        variants, use_kernels=True, device=args.device, clock=ElapsedClock(),
        kv_cache=args.kv_cache, kv_prefix_sharing=args.prefix_sharing,
        scheduler=args.scheduler, preemption=args.preemption,
        async_tick=args.async_tick, speculative=args.speculative,
        spec_k=args.spec_k, trace=args.trace, obs=obs,
        profile_dispatch=args.profile_dispatch, **fabric_kw, **geo)
    for n, p in profiles.items():
        log(f"  {n}: {p.th_slope:.1f} rps/unit, rt {p.rt:.2f}s")

    cfg = ControllerConfig(interval_s=args.interval, budget=budget,
                           slo_ms=args.slo_ms, beta=args.beta, gamma=0.05,
                           reactive=True, queue_aware=True)
    slo_monitor, sink = None, None
    if args.burn_rate_alerts:
        sink = CollectingSink()
        sinks = [sink] + ([FlightTrigger(flight)] if flight is not None
                          else [])
        slo_monitor = SLOMonitor(engine.windows, budget=0.05,
                                 rules=(BurnRateRule(fast_s=5.0, slow_s=30.0,
                                                     threshold=2.0),),
                                 sinks=tuple(sinks))
    ctrl = InfAdapterController(profiles, MovingMaxForecaster(window=10),
                                cfg, burn_alerts=sink)
    faults = None
    if args.fail_node_at is not None:
        faults = FaultSchedule([
            node_crash(args.fail_node_at, "node0"),
            node_recover(args.fail_node_at + 8.0, "node0")])
    vocab = variants[next(iter(variants))][0].vocab_size
    load = args.load or LOAD[args.full_width]
    run_serving_loop(engine, ctrl, seconds=args.seconds,
                     interval=args.interval,
                     load_fn=rise_fall_load(max(args.seconds, 1), *load),
                     prompt_len=geo["prompt_len"], max_new=geo["max_new"],
                     vocab=vocab if args.full_width else 256,
                     faults=faults, slo_ms=args.slo_ms,
                     slo_monitor=slo_monitor, log=log)
    s = engine.summarize(args.slo_ms,
                         max(p.accuracy for p in profiles.values()))
    out = dict(engine=engine, summary=s or None,
               slo_monitor=slo_monitor, flight=flight, reports={},
               faults=faults, controller=ctrl,
               burn_resolves=sum(1 for d in ctrl.audit.entries
                                 if d.reason == "burn_rate"))
    if not s:
        log(f"no requests completed ({engine.rejected} rejected)")
    else:
        log(f"{s['n_requests']} requests: viol={s['violation_rate']:.1%} "
            f"p99={s['p99_ms']:.0f}ms acc_loss={s['accuracy_loss']:.2f}%")
        if "spec_accept_rate" in s:
            log(f"speculative: accept rate {s['spec_accept_rate']:.3f}, "
                f"tokens per verifier step {s['spec_tokens_per_step']:.3f}")
    if slo_monitor is not None:
        log(f"burn-rate alerts: {len(slo_monitor.alerts)} fired, "
            f"{out['burn_resolves']} re-solves")
    if flight is not None:
        for p in flight.dumps:
            log(f"flight dump: {p}")
    if args.trace:
        os.makedirs(args.report_dir, exist_ok=True)
        rep = {k: os.path.join(args.report_dir, k) for k in (
            "TRACE_engine.json", "METRICS_engine.jsonl",
            "AUDIT_decisions.jsonl")}
        n_ev = write_chrome_trace(rep["TRACE_engine.json"], engine.tracer,
                                  label="repro_torch.launch.serve")
        n_m = write_metrics_jsonl(
            rep["METRICS_engine.jsonl"], engine.metrics,
            extra=[{"name": "run.config", "kind": "meta",
                    "arch": args.arch, "full_width": args.full_width,
                    "kv_cache": args.kv_cache, "scheduler": args.scheduler,
                    "async_tick": args.async_tick, "seconds": args.seconds,
                    "slo_ms": args.slo_ms,
                    "profile_dispatch": args.profile_dispatch}])
        n_d = write_audit_jsonl(rep["AUDIT_decisions.jsonl"], ctrl.audit)
        log(f"trace: {rep['TRACE_engine.json']} ({n_ev} events; load in "
            f"Perfetto)")
        log(f"metrics: {rep['METRICS_engine.jsonl']} ({n_m} series)")
        log(f"audit: {rep['AUDIT_decisions.jsonl']} ({n_d} decisions)")
        out["reports"] = rep
    return out


def main(argv=None):
    serve(parse_args(argv))


if __name__ == "__main__":
    main()

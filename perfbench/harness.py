"""One run of one cell: set-up, the measured window, the drain, the
metrics and the check of the outputs.

The loop is the benchmark's own. The schedule is drawn from the seed
(``load.schedule``), block by block as the loop asks. In a closed loop each client
sends its next request when its last one completes; in an open loop each
request is submitted when it falls due. ``engine.step`` is called back to
back, never sleeping, on the benchmark's clock (seconds since the process
started), which the engine stamps ``service_start`` and ``completion``
with. After the window no request is sent; the requests sent in it are
drained, for ``DRAIN_S`` at most, and whatever is left then has failed.

With ``trace`` the engine records its ``TickRecord``s, and before the
window the cell's load runs a stretch under the profiler
(``_traced_stretch``). The per-layer metrics are read from the window's
ticks and requests and from that trace by the readers in ``metrics/``;
the window itself runs as it does untraced.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from perfbench import check, load
from perfbench.frozen import profiler as fprof
from perfbench.frozen.summary import overlap_share, percentile_with_missing
from perfbench.spec import ROOT, Cell, load_cell
from perfbench.weights import make_params

DRAIN_S = 60.0
WARM_S = 4.0
TRACE_S = 4.0
TRACE_TRIES = 3
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run needs more cards than this machine has."""


@dataclass
class Rec:
    """One request of the run, on the benchmark's clock."""
    plan: load.Planned
    due: float
    submit: float = math.nan
    req: object = None
    rejected: bool = False
    seq: int = 0              # submission order

    @property
    def done(self) -> bool:
        return self.req is not None and self.req.completion > 0.0


@dataclass
class RunData:
    """What the metric readers read."""
    cell: Cell
    model: Dict
    geometry: Dict
    w0: float
    w1: float
    recs: List[Rec]
    ticks: List = field(default_factory=list)
    kernels: Optional[List] = None      # (name, start_us, end_us)
    host: Optional[List] = None
    trace_span: Optional[tuple] = None  # (start_us, end_us), device clock
    trace_window_s: float = math.nan
    busy_s: float = math.nan

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def in_window(self) -> List[Rec]:
        return [r for r in self.recs if self.w0 <= r.due < self.w1]


def jax_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def _reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_config(model: Dict, name: str, use_kernels: bool):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=name, use_kernels=use_kernels, **model)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: Path = ROOT, device: str = "cuda",
        log=lambda msg: print(msg, file=sys.stderr, flush=True),
        after_check: Optional[Callable[..., Dict]] = None) -> Dict:
    """Run the cell once and return the result's JSON object. Raises
    ``NoDevice`` without enough cards. ``after_check`` (the control's
    readings) is called with the reference's inputs once the check is done
    and its dict is returned under ``"extra"``."""
    import torch
    cell = load_cell(cell_name, root)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"{cell_name} needs {cell.chips} CUDA device(s); "
                       f"this machine has {have}")
    torch.set_num_threads(4)
    on_card = device == "cuda"
    clock = lambda: time.perf_counter() - t_start        # noqa: E731
    model, geo, traffic = cell.config["model"], cell.geometry, cell.traffic
    if model.get("num_experts", 0) and (model["moe_capacity_factor"]
                                        * model["experts_per_token"]
                                        < model["num_experts"]):
        raise ValueError(f"{cell.config['name']}: an expert's capacity "
                         "could drop tokens; the reference's router is "
                         "dropless (moe_capacity_factor >= num_experts / "
                         "experts_per_token)")
    name = cell.config["name"]
    cfg = _model_config(model, name, on_card)
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import InProcessServingEngine

    t_imp = clock()
    params = make_params(model, seed, device)
    if on_card:
        torch.cuda.synchronize()
    t_w = clock()
    engine = InProcessServingEngine(
        {name: (cfg, 100.0)}, max_batch=geo["max_batch"],
        prompt_len=geo["prompt_len"], max_new=geo["max_new"],
        decode_chunk=geo["decode_chunk"], use_kernels=on_card,
        device=device, weights={name: params}, clock=clock,
        trace=bool(trace), queue_cap=geo.get("queue_cap", 256))
    engine.apply_allocation(clock(), {name: 1})
    backend = engine.backends[name]
    t_e = clock()

    # warm-up: one full batch through admission, a decode chunk, the
    # read-back and retirement, on the timed path's shapes
    warm = [Request(rid=-1 - j, tokens=np.ones(geo["prompt_len"], np.int64),
                    max_new=geo["decode_chunk"] + 1, arrival=clock())
            for j in range(geo["max_batch"])]
    for r in warm:
        engine.submit(r, name)
    while not all(r.completion > 0 for r in warm):
        engine.step(clock())
    if on_card:
        torch.cuda.synchronize()
    closed = traffic["loop"] == "closed"
    traced = None
    if trace and on_card:
        traced = _traced_stretch(engine, name, traffic, geo, model, seed,
                                 clock, log)
        engine.tracer.ticks.clear()
    plan = load.schedule(traffic, geo, model["vocab_size"], seed, seconds)
    gc.collect()
    gc.freeze()

    w0 = clock()
    w1 = w0 + seconds
    setup_s = w0
    log(f"[perfbench] set-up: imports {t_imp:.3f} s, weights "
        f"{t_w - t_imp:.3f} s, engine and captures {t_e - t_w:.3f} s "
        f"(readiness {backend.readiness_s:.3f} s), warm-up "
        f"{w0 - t_e:.3f} s")
    loop = Loop(engine, name, plan, closed, w0, clock)
    if closed:
        loop.open_clients(int(traffic["clients_per_slot"]
                              * geo["max_batch"]))
    loop.run(w1, send_until=w1)
    recs = loop.recs
    loop.drain(DRAIN_S)
    if on_card:
        torch.cuda.synchronize()
    found = jax_loaded()
    if found:
        raise RuntimeError(f"JAX or the JAX package is loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    data = RunData(cell=cell, model=model, geometry=geo, w0=w0, w1=w1,
                   recs=recs, ticks=list(engine.tracer.ticks))
    if traced is not None:
        data.kernels, data.host, data.trace_span = traced
        data.trace_window_s = (data.trace_span[1]
                               - data.trace_span[0]) * 1e-6
        data.busy_s = fprof.busy_union_us(data.kernels) * 1e-6
    result_metrics = (per_layer(data, root) if trace
                      else end_to_end(data, setup_s))

    # free the program's state, then check its outputs
    served = [check.Served(seq=r.seq, prompt=r.plan.tokens,
                           output=np.asarray(r.req.output, np.int64))
              for r in recs if r.done]
    engine.apply_allocation(clock(), {})
    del engine, backend
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = geo["limits"]
    group = check.sample(served, seed, int(limits["tokens_compared"]),
                         int(geo.get("check_rows", 8)))
    t_ref = time.perf_counter()
    got = check.widest_gap(model, params, group, geo["prompt_len"])
    ref_s = time.perf_counter() - t_ref
    judged = check.judge(got, limits)
    correct = all(j["ok"] for j in judged.values())
    checks = {k: {"value": j["value"], "limit": j["limit"]}
              for k, j in judged.items()}
    in_win = data.in_window()
    failed = sum(1 for r in in_win if not r.done)
    out = {"correct": bool(correct), "attempted": len(in_win),
           "failed": failed, "metrics": result_metrics,
           "device": device_info(torch, on_card, peak, data, trace)}
    if trace and data.kernels is not None:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in fprof.top_kernels(
                data.kernels)],
            "idle_gaps": [[n, s] for n, s in fprof.idle_gaps(
                data.kernels, data.host, *data.trace_span)[:10]]}
    if after_check is not None:
        out["extra"] = after_check(
            data=data, model=model, params=params, group=group,
            prompt_len=geo["prompt_len"], got=got)
    out["checks"] = checks
    log(f"[perfbench] {cell_name} seed {seed}: setup {setup_s:.3f} s, "
        f"window {seconds} s, {len(in_win)} requests in the window, "
        f"{failed} failed, reference {ref_s:.1f} s over "
        f"{got['requests_compared']} requests; {power_limit()}")
    for k, v in checks.items():
        log(f"[check] {k} {v['value']} limit {v['limit']}")
    return out


class Loop:
    """The benchmark's loop over one schedule: a closed loop's clients send
    their next request when the last completes, an open loop submits each
    request when it falls due; ``engine.step`` runs back to back."""

    def __init__(self, engine, name: str, plan: Iterator[load.Planned],
                 closed: bool, t0: float, clock, scope=None):
        self.engine, self.name, self.plan = engine, name, plan
        self.closed, self.t0, self.clock = closed, t0, clock
        self.scope = scope or (lambda label: contextlib.nullcontext())
        self.recs: List[Rec] = []
        self.inflight: List[Rec] = []
        self.nxt: Optional[load.Planned] = next(plan, None)

    def send(self, due: float) -> Optional[Rec]:
        if self.nxt is None:
            raise RuntimeError("the schedule ended while the loop was "
                               "still sending")
        from repro_torch.serving.api import Request
        p, self.nxt = self.nxt, next(self.plan, None)
        rec = Rec(plan=p, due=due, seq=len(self.recs))
        rec.req = Request(rid=p.idx, tokens=p.tokens, max_new=p.max_new,
                          arrival=due)
        rec.submit = self.clock()
        rec.rejected = not self.engine.submit(rec.req, self.name)
        self.recs.append(rec)
        return rec

    def open_clients(self, n: int) -> None:
        for _ in range(n):
            rec = self.send(self.t0)
            if not rec.rejected:
                self.inflight.append(rec)

    def run(self, until: float, send_until: float) -> None:
        """Step until ``until``; a closed loop's clients send while their
        last request completed before ``send_until``."""
        now = self.clock()
        while now < until:
            with self.scope("bench.submit"):
                while (not self.closed and self.nxt is not None
                       and self.t0 + self.nxt.due <= now):
                    self.send(self.t0 + self.nxt.due)
            with self.scope("bench.step"):
                self.engine.step(now)
            with self.scope("bench.collect"):
                if self.closed:
                    still = []
                    for r in self.inflight:
                        if not r.done:
                            still.append(r)
                        elif r.req.completion < send_until:
                            nxt = self.send(r.req.completion)
                            if not nxt.rejected:
                                still.append(nxt)
                    self.inflight = still
            now = self.clock()

    def drain(self, limit_s: float) -> None:
        """Step until every request sent has completed, ``limit_s`` at
        most."""
        limit = self.clock() + limit_s
        while (any(not r.done for r in self.recs if not r.rejected)
               and self.clock() < limit):
            self.engine.step(self.clock())


def _traced_stretch(engine, name, traffic, geo, model, seed, clock, log):
    """The device trace of a traced run, taken before the window: the
    cell's load (a schedule of its own, from the seed) runs ``WARM_S``
    untraced, then ``TRACE_S`` under the profiler, again up to
    ``TRACE_TRIES`` times until the trace is whole; then it is drained, so
    the window starts from an idle engine as in an untraced run (a trace
    taken late in a long process comes back empty more often). Returns
    (kernels, host ranges, (window start, end) in µs on the device's
    clock); raises when no trace was whole, so that no run reports a
    device time that it did not read."""
    import torch
    # the first trace of a process is the one most often left empty
    prof = fprof.start()
    engine.step(clock())
    fprof.stop(prof)
    fprof.close(prof)
    fprof.parse(prof)
    horizon = WARM_S + TRACE_TRIES * (TRACE_S + 60.0)
    plan = load.schedule(traffic, geo, model["vocab_size"], seed + 7919,
                         horizon)
    t0 = clock()
    loop = Loop(engine, name, plan, traffic["loop"] == "closed", t0, clock,
                scope=torch.profiler.record_function)
    if loop.closed:
        loop.open_clients(int(traffic["clients_per_slot"]
                              * engine.max_batch))
    loop.run(t0 + WARM_S, send_until=math.inf)
    traced = None
    for _ in range(TRACE_TRIES):
        prof, t_a = fprof.start(), clock()
        loop.run(t_a + TRACE_S, send_until=math.inf)
        fprof.stop(prof)
        t_b = clock()
        fprof.close(prof)
        traced = fprof.parse(prof, log)
        log(f"[perfbench] trace stretch {t_b - t_a:.3f} s, read in "
            f"{clock() - t_b:.3f} s, whole: {traced is not None}"
            + (f", device window {(traced[2][1] - traced[2][0]) * 1e-6:.3f}"
               " s" if traced else ""))
        if traced is not None:
            break
    loop.drain(DRAIN_S)
    if traced is None:
        raise RuntimeError(f"no whole device trace in {TRACE_TRIES} tries")
    return traced


def device_info(torch, on_card: bool, peak: int, data: RunData,
                trace: bool) -> Dict:
    d = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
         "count": data.cell.chips, "memory_peak_bytes": int(peak)}
    if trace and on_card:
        d["busy_s"] = data.busy_s
        d["window_s"] = data.trace_window_s
    return d


def end_to_end(data: RunData, setup_s: float) -> Dict:
    """The cell's end-to-end metrics, by name."""
    out = {}
    for m in data.cell.end_to_end:
        v = E2E[m["name"]](data, setup_s)
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def per_layer(data: RunData, root: Path) -> Dict:
    """The cell's per-layer metrics its readers find something to read."""
    out = {}
    for m in data.cell.per_layer:
        v = _reader(root, m["name"]).read(data)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _tokens_per_s(data: RunData, _setup: float) -> float:
    tok = sum(len(r.req.output) * overlap_share(
        r.req.service_start, r.req.completion, data.w0, data.w1)
        for r in data.recs if r.done)
    return tok / data.seconds


def _p95_latency_ms(data: RunData, _setup: float) -> float:
    return percentile_with_missing(
        [(r.req.completion - r.due) * 1e3 if r.done else None
         for r in data.in_window()], 95)


E2E = {"setup_s": lambda data, setup_s: setup_s,
       "output_tokens_per_s": _tokens_per_s,
       "p95_latency_ms": _p95_latency_ms}

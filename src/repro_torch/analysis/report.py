"""Generate the §Dry-run, §Roofline, §Profiles, §Cluster-fabric, and
§Paged-KV markdown tables in EXPERIMENTS.md from reports/dryrun/*.json,
reports/profiles/*.json, reports/cluster/*.json, and
reports/BENCH_engine.json (the latter two written by
``benchmarks/bench_cluster.py`` / ``benchmarks/bench_engine.py``).

Usage: PYTHONPATH=src python -m repro_torch.analysis.report [--dir reports/dryrun]
           [--profiles-dir reports/profiles] [--cluster-dir reports/cluster]
           [--bench-engine reports/BENCH_engine.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def dryrun_table(rows) -> str:
    out = ["| arch | shape | 16×16 | 2×16×16 | HBM-est/dev | fallbacks |",
           "|---|---|---|---|---|---|"]
    by_key = {}
    for d in rows:
        if d.get("skipped"):
            by_key.setdefault((d["arch"], d["shape"]), {})["skip"] = d["reason"]
            continue
        if "error" in d:
            by_key.setdefault((d["arch"], d["shape"]), {})[d.get("mesh", "?")] = "ERROR"
            continue
        by_key.setdefault((d["arch"], d["shape"]), {})[d["mesh"]] = d
    for (arch, shape), entry in sorted(by_key.items()):
        if "skip" in entry:
            out.append(f"| {arch} | {shape} | SKIP | SKIP | — | "
                       f"{entry['skip'][:60]}… |")
            continue
        d1 = entry.get("16x16")
        d2 = entry.get("2x16x16")
        def cell(d):
            if d is None:
                return "—"
            if d == "ERROR":
                return "FAIL"
            return f"✓ {d['compile_s']:.0f}s"
        hbm = (f"{d1['hbm_estimate_bytes']/1e9:.1f} GB "
               f"({'fits' if d1.get('fits_v5e_16gb') else 'needs μbatch'})"
               if isinstance(d1, dict) else "—")
        fb = len(d1.get("sharding_fallbacks", [])) if isinstance(d1, dict) else 0
        out.append(f"| {arch} | {shape} | {cell(d1)} | {cell(d2)} | {hbm} | "
                   f"{fb} |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant | "
           "useful | note |",
           "|---|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda d: (d.get("arch", ""), d.get("shape", ""))):
        if d.get("skipped") or "error" in d or d.get("mesh") != "16x16":
            continue
        note = (d.get("notes") or "")[:48]
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['compute_s']:.3f} | "
            f"{d['memory_s']:.3f} | {d['collective_s']:.3f} | "
            f"**{d['dominant']}** | {d['usefulness']:.2f} | {note} |")
    return "\n".join(out)


def profiles_table(profiles_dir: str) -> str:
    """One row per stored variant profile across every store JSON in the
    directory: provenance, fitted curves, confidence — the §Profiles audit
    table (which numbers the solver is trusting, and why)."""
    out = ["| store | variant | provenance | th(n) rps | R² | p(n) ms | "
           "rt s | acc |",
           "|---|---|---|---|---|---|---|---|"]
    from repro_torch.profiling.store import ProfileStore
    for f in sorted(glob.glob(os.path.join(profiles_dir, "*.json"))):
        try:
            store = ProfileStore.load(f)
        except (ValueError, KeyError, json.JSONDecodeError):
            out.append(f"| {os.path.basename(f)} | — | UNREADABLE | | | | | |")
            continue
        for name in store.names():
            e = store.entry(name)
            p = e.profile
            r2 = f"{e.fit.r_squared:.3f}" if e.fit is not None else "—"
            out.append(
                f"| {os.path.basename(f)} | {name} | {e.provenance} | "
                f"{p.th_slope:.1f}·n{p.th_intercept:+.1f} | {r2} | "
                f"{p.lat_base_ms:.1f}+{p.lat_k_ms:.1f}/n | {p.rt:.2f} | "
                f"{p.accuracy:.1f} |")
    return "\n".join(out)


def _cluster_rows(cluster_dir: str, study: str):
    path = os.path.join(cluster_dir, f"{study}.json")
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            return json.load(f).get("rows", [])
    except (ValueError, json.JSONDecodeError):
        return []


def cluster_scaling_table(cluster_dir: str) -> str:
    """Replica scaling + routing policy (§Cluster fabric): throughput/P99 vs
    replica count at fixed load, and two-level vs WRR-only routing."""
    out = ["| study | config | offered rps | achieved rps | p99 ms | viol |",
           "|---|---|---|---|---|---|"]
    for d in _cluster_rows(cluster_dir, "replica_scaling"):
        out.append(f"| scaling | {d['replicas']}×{d['units_per_replica']}u "
                   f"| {d['offered_rps']:.0f} | {d['achieved_rps']:.1f} | "
                   f"{d['p99_ms']:.0f} | {d['violation_rate']:.3f} |")
    for d in _cluster_rows(cluster_dir, "routing_policy"):
        kind = "two-level" if d["two_level"] else "WRR-only"
        out.append(f"| routing | {d['router']} ({kind}) | "
                   f"{d['offered_rps']:.0f} | — | {d['p99_ms']:.0f} | "
                   f"{d['violation_rate']:.3f} |")
    return "\n".join(out)


def cluster_failure_table(cluster_dir: str) -> str:
    """Failure-recovery phases (§Cluster fabric): violation rate and P99
    before, during, and after a node crash, per scenario."""
    out = ["| scenario | phase | viol | p99 ms | n |",
           "|---|---|---|---|---|"]
    for d in _cluster_rows(cluster_dir, "failure_recovery"):
        out.append(f"| {d['scenario']} | {d['phase']} | "
                   f"{d['violation_rate']:.3f} | {d['p99_ms']:.0f} | "
                   f"{d['n']} |")
    return "\n".join(out)


def paged_engine_tables(bench_path: str):
    """§Paged KV cache: occupancy cells (P50/P99 step latency + throughput,
    dense vs paged) and the context-scaling sweep, from the machine-readable
    BENCH_engine.json the engine benchmark emits (also a CI artifact)."""
    occ = ["| occupancy | slots | dense p50/p99 ms | paged p50/p99 ms | "
           "p99 ratio | thr ratio |",
           "|---|---|---|---|---|---|"]
    ctx = ["| context tokens | dense step ms | paged step ms |",
           "|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(occ), "\n".join(ctx)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(occ), "\n".join(ctx)
    for c in data.get("occupancy", []):
        d, p = c["dense"], c["paged"]
        occ.append(f"| {c['occupancy']:.0%} | {c['slots']} | "
                   f"{d['p50_step_ms']:.1f}/{d['p99_step_ms']:.1f} | "
                   f"{p['p50_step_ms']:.1f}/{p['p99_step_ms']:.1f} | "
                   f"**{c['p99_ratio']:.2f}** | {c['throughput_ratio']:.2f} |")
    ml = data.get("mixed_load", {})
    if "dense" in ml and "paged" in ml:
        occ.append(f"| mixed load | {data['config']['max_batch']} | "
                   f"thr {ml['dense']['throughput_rps']:.1f} rps | "
                   f"thr {ml['paged']['throughput_rps']:.1f} rps | — | "
                   f"**{ml['throughput_ratio']:.2f}** |")
    cs = data.get("context_scaling", {})
    dense_pts = {r["context_tokens"]: r["mean_step_ms"]
                 for r in cs.get("dense", [])}
    paged_pts = {r["context_tokens"]: r["mean_step_ms"]
                 for r in cs.get("paged", [])}
    for c in sorted(set(dense_pts) | set(paged_pts)):
        dv = f"{dense_pts[c]:.1f}" if c in dense_pts else "—"
        pv = f"{paged_pts[c]:.1f}" if c in paged_pts else "—"
        ctx.append(f"| {c} | {dv} | {pv} |")
    return "\n".join(occ), "\n".join(ctx)


def prefix_sharing_table(bench_path: str) -> str:
    """§Prefix sharing: sharing-off vs sharing-on on the shared-prefix
    workload — prefill tokens actually computed, fresh pages allocated vs
    the worst-case (refcount-free) footprint, and the index hit rate —
    from the ``prefix_sharing`` cell of BENCH_engine.json."""
    out = ["| metric | sharing off | sharing on | ratio |",
           "|---|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(out)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    c = data.get("prefix_sharing")
    if not c:
        return "\n".join(out)
    off, on = c["off"], c["on"]
    out.append(f"| prefill tokens | {off['prefill_tokens']} | "
               f"{on['prefill_tokens']} | "
               f"**{c['prefill_token_reduction']:.2f}×** (gate ≥2) |")
    out.append(f"| fresh pages allocated | {off['fresh_pages_allocated']} | "
               f"{on['fresh_pages_allocated']} | "
               f"{c['capacity_uplift']:.2f}× fewer |")
    out.append(f"| prefix hit rate | — | "
               f"{on['prefix_hits']}/{on['prefix_lookups']} = "
               f"**{on['prefix_hit_rate']:.2f}** (gate ≥0.8) | — |")
    out.append(f"| makespan s | {off['makespan_s']:.2f} | "
               f"{on['makespan_s']:.2f} | "
               f"{off['makespan_s'] / max(on['makespan_s'], 1e-9):.2f}× |")
    return "\n".join(out)


def scheduler_table(bench_path: str) -> str:
    """§Scheduling: per-policy goodput / P99 / short-class P99 / throughput
    on the bimodal prompt-length workload at fixed allocation, plus the
    chunked-vs-FIFO acceptance ratios, from BENCH_scheduler.json (written
    by ``benchmarks/bench_scheduler.py``, a CI artifact)."""
    out = ["| policy | goodput | p99 ms | short p99 ms | queue p99 ms | "
           "thr rps |",
           "|---|---|---|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(out)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    for name, d in data.get("policies", {}).items():
        out.append(f"| {name} | {d['goodput']:.3f} | {d['p99_ms']:.0f} | "
                   f"{d['short_p99_ms']:.0f} | {d['p99_queue_ms']:.0f} | "
                   f"{d['throughput_rps']:.1f} |")
    rr = data.get("ratios", {})
    if rr:
        out.append(f"| **chunked / fifo** | "
                   f"**{rr['goodput_ratio']:.2f}×** (gate ≥1.1) | "
                   f"**{rr['p99_ratio']:.2f}×** (gate ≤0.8) | "
                   f"{rr['short_p99_ratio']:.2f}× | — | — |")
    return "\n".join(out)


def observability_table(bench_path: str) -> str:
    """§Observability: per-tick cost at each instrumentation level
    (disabled / metrics-only / traced), the no-op-hook overhead gate, and
    the exported artifact inventory — from the ``observability`` cell of
    BENCH_engine.json."""
    out = ["| level | mean tick ms | p99 tick ms | ratio |",
           "|---|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(out)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    c = data.get("observability")
    if not c:
        return "\n".join(out)
    ticks = c.get("ticks", {})
    ratios = {"disabled": (1.0, "—"),
              "metrics": (c.get("metrics_over_disabled"), "vs disabled"),
              "traced": (c.get("traced_over_disabled"), "vs disabled"),
              "windowed": (c.get("windowed_over_disabled"), "vs disabled"),
              "profiled": (c.get("profiled_over_traced"), "vs traced")}
    for level in ("disabled", "metrics", "traced", "windowed", "profiled"):
        t = ticks.get(level)
        if not t:
            continue
        r, vs = ratios[level]
        rs = f"{r:.3f}× {vs}" if isinstance(r, (int, float)) else "—"
        out.append(f"| {level} | {t['mean_step_ms']:.2f} | "
                   f"{t['p99_step_ms']:.2f} | {rs} |")
    out.append(f"| no-op hook budget | "
               f"{c.get('noop_hook_ns', float('nan')):.0f} ns × "
               f"{c.get('hooks_per_tick_budget', 0)}/tick | — | "
               f"**{c.get('disabled_hook_frac', float('nan')):.4f}** "
               f"(gate ≤{c.get('gate_frac', 0.02)}) |")
    smoke = c.get("burn_smoke")
    if smoke:
        out.append(f"| burn-rate smoke | {smoke.get('alerts_fired', 0)} "
                   f"alerts | flight: "
                   f"{os.path.basename(smoke.get('flight_dump') or '—')} | "
                   f"drops {smoke.get('spans_dropped', 0):.0f}/"
                   f"{smoke.get('ticks_dropped', 0):.0f} |")
    art = c.get("artifacts", {})
    if art:
        out.append(f"| artifacts | {art.get('trace', '—')} "
                   f"({art.get('trace_events', 0)} events) | "
                   f"{art.get('metrics', '—')} "
                   f"({art.get('metric_rows', 0)} rows) | "
                   f"{art.get('requests', 0)} traced requests |")
    return "\n".join(out)


def spec_decode_table(bench_path: str) -> str:
    """§Speculative decoding: per-drafter-arm acceptance, accepted tokens
    per verifier step, and the virtual-clock tick count against target-only
    decoding — the ``spec_decode`` cell of BENCH_engine.json. Both arms are
    parity-gated (greedy acceptance makes speculative output bitwise equal
    to the verifier's own stream for ANY drafter); only the correlated
    arm's acceptance/speedup is a hard gate."""
    out = ["| drafter arm | accept rate | tokens/verifier step | "
           "ticks (vs target-only) | parity | pages leaked |",
           "|---|---|---|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(out)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    c = data.get("spec_decode")
    if not c:
        return "\n".join(out)
    tgt = c.get("target", {}).get("ticks", 0)
    cfg = c.get("config", {})
    for arm in ("correlated", "ladder"):
        cell = c.get(arm)
        if not cell:
            continue
        leaks = cell.get("leaks", {})
        leaked = (leaks.get("verifier_used_pages", 0)
                  + leaks.get("drafter_used_pages", 0))
        out.append(
            f"| {arm} (k={cfg.get('k', '—')}) | "
            f"{cell.get('accept_rate', float('nan')):.3f} | "
            f"**{cell.get('tokens_per_step', float('nan')):.2f}** "
            f"(gate ≥{cfg.get('tps_gate', 1.5)}"
            f"{' on this arm' if arm == 'correlated' else ', ungated'}) | "
            f"{cell.get('ticks', 0)} vs {tgt} "
            f"(×{cell.get('tick_ratio', float('nan')):.2f}) | "
            f"{'bitwise' if cell.get('parity') else 'FAIL'} | {leaked} |")
    return "\n".join(out)


def dispatch_floor_table(bench_path: str) -> str:
    """§Dispatch floor: per-tick-type host/device split from the sampled
    (fenced) ticks — the ``dispatch_floor`` cell of BENCH_engine.json. The
    off-device fraction (dispatch + host-sync share of the exec phase) is
    the budget the async two-phase tick loop overlaps away; when the
    ``async_overlap`` study has run, a second table compares the sync
    baseline's exposed fraction against the async loop's (only the commit
    wait stays exposed — dispatch, bookkeeping, and the D2H read ride
    behind the in-flight exec; DESIGN.md §Async tick loop)."""
    out = ["| tick kind | n | dispatch ms mean/p50 | device ms mean/p50 | "
           "host-sync ms mean/p50 | exec ms | off-device frac |",
           "|---|---|---|---|---|---|---|"]
    if not os.path.exists(bench_path):
        return "\n".join(out)
    try:
        with open(bench_path) as f:
            data = json.load(f)
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    floor = (data.get("observability") or {}).get("dispatch_floor") or {}
    for kind, d in sorted(floor.items()):
        off = d["dispatch_frac"] + d["host_sync_frac"]
        out.append(
            f"| {kind} | {d['n_sampled']} | "
            f"{d['dispatch_ms_mean']:.2f}/{d['dispatch_ms_p50']:.2f} | "
            f"{d['device_ms_mean']:.2f}/{d['device_ms_p50']:.2f} | "
            f"{d['host_sync_ms_mean']:.2f}/{d['host_sync_ms_p50']:.2f} | "
            f"{d['exec_ms_mean']:.2f} | **{off:.2f}** |")
    ao = data.get("async_overlap") or {}
    if ao:
        com = (ao.get("async") or {}).get("commit") or {}
        offd = ao.get("off_device_frac") or {}
        gate_note = ("single-core host: no-regression bound"
                     if ao.get("single_core")
                     else f"multi-core gate <= {ao.get('gate', 0.9)}")
        out += ["",
                "Async two-phase tick loop vs sync at the overlap geometry "
                "(`async_overlap` study; decode ticks):",
                "",
                "| mode | mean step ms | exposed off-device frac | "
                "hidden host ms/tick | commit wait ms |",
                "|---|---|---|---|---|",
                f"| sync | {ao.get('sync', {}).get('mean_step_ms', 0):.3f} | "
                f"**{offd.get('sync', 0):.3f}** | — | — |",
                f"| async | {ao.get('async', {}).get('mean_step_ms', 0):.3f}"
                f" | **{offd.get('async', 0):.3f}** | "
                f"{com.get('hidden_host_ms_mean', 0):.3f} | "
                f"{com.get('commit_wait_ms_mean', 0):.3f} |",
                "",
                f"step ratio async/sync = {ao.get('step_ratio', 0):.3f} "
                f"({ao.get('cores', '?')} core(s); {gate_note}); greedy "
                f"outputs bitwise identical on "
                f"{(ao.get('parity') or {}).get('n_requests', 0)} requests."]
    return "\n".join(out)


def audit_table(audit_path: str, max_rows: int = 12) -> str:
    """§Observability: controller decisions with predicted vs measured
    latency/goodput and the regret per decision window — from the
    AUDIT_decisions.jsonl a traced driver run exports (empty table until
    one has been run)."""
    out = ["| t | reason | units | pred p99 / meas p99 ms | "
           "pred / meas goodput | p99 regret ms |",
           "|---|---|---|---|---|---|"]
    if not os.path.exists(audit_path):
        return "\n".join(out)
    rows = []
    try:
        with open(audit_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
    except (ValueError, json.JSONDecodeError):
        return "\n".join(out)
    for d in rows[:max_rows]:
        units = {m: n for m, n in d.get("outputs", {}).get("units", {}).items()
                 if n}
        pred = d.get("outputs", {}).get("predicted", {})
        meas = d.get("measured") or {}
        reg = d.get("regret") or {}
        ustr = ",".join(f"{m}:{n}" for m, n in sorted(units.items())) or "—"

        def num(v, fmt="{:.0f}"):
            return fmt.format(v) if isinstance(v, (int, float)) else "—"
        out.append(
            f"| {d['t']:.0f} | {d.get('reason', '?')} | {ustr} | "
            f"{num(pred.get('p99_ms'))} / {num(meas.get('p99_ms'))} | "
            f"{num(pred.get('goodput'), '{:.2f}')} / "
            f"{num(meas.get('goodput'), '{:.2f}')} | "
            f"{num(reg.get('p99_ms'), '{:+.0f}')} |")
    if len(rows) > max_rows:
        out.append(f"| … | {len(rows) - max_rows} more decisions "
                   f"in {audit_path} | | | | |")
    return "\n".join(out)


def inject(md_path: str, marker: str, table: str) -> None:
    with open(md_path) as f:
        text = f.read()
    begin = f"<!-- {marker} -->"
    end = f"<!-- /{marker} -->"
    block = f"{begin}\n{table}\n{end}"
    if begin in text and end in text:
        pre = text.split(begin)[0]
        post = text.split(end)[1]
        text = pre + block + post
    elif begin in text:
        text = text.replace(begin, block)
    with open(md_path, "w") as f:
        f.write(text)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun")
    ap.add_argument("--profiles-dir", default="reports/profiles")
    ap.add_argument("--cluster-dir", default="reports/cluster")
    ap.add_argument("--bench-engine", default="reports/BENCH_engine.json")
    ap.add_argument("--bench-scheduler",
                    default="reports/BENCH_scheduler.json")
    ap.add_argument("--audit", default="reports/AUDIT_decisions.jsonl")
    ap.add_argument("--md", default="EXPERIMENTS.md")
    args = ap.parse_args()
    rows = load(args.dir)
    inject(args.md, "DRYRUN_TABLE", dryrun_table(rows))
    inject(args.md, "ROOFLINE_TABLE", roofline_table(rows))
    inject(args.md, "PROFILES_TABLE", profiles_table(args.profiles_dir))
    inject(args.md, "CLUSTER_SCALING_TABLE",
           cluster_scaling_table(args.cluster_dir))
    inject(args.md, "CLUSTER_FAILURE_TABLE",
           cluster_failure_table(args.cluster_dir))
    occ_tbl, ctx_tbl = paged_engine_tables(args.bench_engine)
    inject(args.md, "PAGED_ENGINE_TABLE", occ_tbl)
    inject(args.md, "PAGED_CONTEXT_TABLE", ctx_tbl)
    inject(args.md, "PREFIX_SHARING_TABLE",
           prefix_sharing_table(args.bench_engine))
    inject(args.md, "SCHEDULER_TABLE", scheduler_table(args.bench_scheduler))
    inject(args.md, "OBS_OVERHEAD_TABLE",
           observability_table(args.bench_engine))
    inject(args.md, "OBS_AUDIT_TABLE", audit_table(args.audit))
    inject(args.md, "DISPATCH_FLOOR_TABLE",
           dispatch_floor_table(args.bench_engine))
    inject(args.md, "SPEC_DECODE_TABLE",
           spec_decode_table(args.bench_engine))
    n_ok = sum(1 for d in rows if not d.get("skipped") and "error" not in d)
    n_skip = sum(1 for d in rows if d.get("skipped"))
    n_err = sum(1 for d in rows if "error" in d)
    print(f"tables written: ok={n_ok} skip={n_skip} err={n_err}")


if __name__ == "__main__":
    main()

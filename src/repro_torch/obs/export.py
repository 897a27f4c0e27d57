"""File exporters + schema validators for the observability artifacts.

Three artifact kinds, all written under ``reports/`` by benchmarks and
``examples/serve_autoscale.py --trace``:

* ``TRACE_engine.json``    — Chrome ``trace_event`` JSON (Perfetto-loadable)
* ``METRICS_engine.jsonl`` — one registry instrument snapshot per line
* ``AUDIT_decisions.jsonl``— one controller decision per line

(Flight-recorder ``FLIGHT_<reason>.json`` dumps are the same Chrome
trace_event schema as ``TRACE_engine.json`` — validate them with
``--validate-trace`` too.)

The module doubles as the CI schema gate::

    python -m repro_torch.obs.export --validate-trace reports/TRACE_engine.json \
                               --validate-metrics reports/METRICS_engine.jsonl \
                               --assert-zero obs.spans_dropped

exits non-zero on the first malformed artifact, and ``--assert-zero NAME``
fails if any validated metrics file carries a nonzero (or missing) counter
``NAME`` — the CI smoke uses it to prove the tracer never dropped a span.

``--summarize <file.jsonl>`` pretty-prints a metrics or audit dump (the
file kind is sniffed from the rows) as an aligned table for eyeballing
runs without loading artifacts into a UI.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, Optional

from .audit import DecisionAudit
from .registry import MetricsRegistry
from .trace import Tracer, to_chrome_trace, validate_chrome_trace

__all__ = ["write_chrome_trace", "write_metrics_jsonl", "write_audit_jsonl",
           "validate_trace_file", "validate_metrics_file", "assert_zero",
           "summarize_file"]


def write_chrome_trace(path: str, tracer: Tracer,
                       label: str = "repro") -> int:
    """Render ``tracer`` to Chrome trace_event JSON at ``path``. The
    object is validated before writing — we never emit a malformed trace.
    Returns the event count."""
    obj = to_chrome_trace(tracer, label=label)
    n = validate_chrome_trace(obj)
    with open(path, "w") as f:
        json.dump(obj, f)
    return n


def write_metrics_jsonl(path: str, registry: MetricsRegistry,
                        extra: Optional[Iterable[Dict]] = None) -> int:
    """Dump every registry instrument as one JSON object per line."""
    return registry.dump_jsonl(path, extra=extra)


def write_audit_jsonl(path: str, audit: DecisionAudit) -> int:
    """Dump the controller decision log, one decision per line."""
    return audit.to_jsonl(path)


# ------------------------------------------------------------- validation
def validate_trace_file(path: str) -> int:
    """Load + schema-check a trace_event JSON file. Returns event count;
    raises ``ValueError`` on malformed content."""
    with open(path) as f:
        obj = json.load(f)
    return validate_chrome_trace(obj)


def validate_metrics_file(path: str) -> int:
    """Schema-check a metrics JSONL dump: every line a JSON object with a
    ``name`` and a known ``kind``. Returns the row count."""
    kinds = {"counter", "gauge", "histogram", "meta",
             "window_counter", "window_histogram"}
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if not isinstance(row, dict):
                raise ValueError(f"{path}:{i + 1}: row is not an object")
            if not isinstance(row.get("name"), str):
                raise ValueError(f"{path}:{i + 1}: missing 'name'")
            if row.get("kind") not in kinds:
                raise ValueError(f"{path}:{i + 1}: unknown kind "
                                 f"{row.get('kind')!r}")
            n += 1
    if n == 0:
        raise ValueError(f"{path}: empty metrics dump")
    return n


def assert_zero(path: str, name: str) -> None:
    """Assert that counter ``name`` exists in metrics JSONL ``path`` with
    value 0 — missing is as loud as nonzero (an absent drop counter means
    the instrumentation was never armed, which is its own bug)."""
    found = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("name") == name and row.get("kind") == "counter":
                found = float(row.get("value", 0.0))
    if found is None:
        raise ValueError(f"{path}: counter {name!r} not present")
    if found != 0.0:
        raise ValueError(f"{path}: counter {name!r} = {found:g}, expected 0")


# ------------------------------------------------------------- summarize
def _load_jsonl(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _table(header: list, rows: Iterable[list]) -> str:
    """Align columns: first column left, the rest right."""
    cells = [header] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(header))]
    out = []
    for r in cells:
        out.append("  ".join(
            r[i].ljust(widths[i]) if i == 0 else r[i].rjust(widths[i])
            for i in range(len(r))))
    return "\n".join(out)


def _fmt(v: Any, nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _summarize_metrics(rows: list) -> str:
    header = ["name", "kind", "value", "count", "mean", "p50", "p95", "p99"]
    body = []
    for r in sorted(rows, key=lambda r: (r.get("kind") == "meta",
                                         r.get("name", ""))):
        body.append([r.get("name", "?"), r.get("kind", "?"),
                     _fmt(r.get("value")), _fmt(r.get("count")),
                     _fmt(r.get("mean")), _fmt(r.get("p50")),
                     _fmt(r.get("p95")), _fmt(r.get("p99"))])
    return _table(header, body)


def _summarize_audit(rows: list) -> str:
    header = ["t", "reason", "controller", "lam", "units", "objective",
              "pred_p99", "meas_p99", "n_req"]
    body = []
    for r in rows:
        ins = r.get("inputs", {}) or {}
        outs = r.get("outputs", {}) or {}
        pred = outs.get("predicted", {}) or {}
        meas = r.get("measured", {}) or {}
        units = outs.get("units", {}) or {}
        body.append([_fmt(r.get("t")), r.get("reason", "-"),
                     r.get("controller", "-"), _fmt(ins.get("lam")),
                     "+".join(f"{m}:{n}" for m, n in sorted(units.items())
                              if n) or "-",
                     _fmt(outs.get("objective"), 3),
                     _fmt(pred.get("p99_ms")), _fmt(meas.get("p99_ms")),
                     _fmt(meas.get("n_requests"))])
    return _table(header, body)


def summarize_file(path: str) -> str:
    """Aligned pretty-print of a metrics or audit JSONL dump; the kind is
    sniffed from the first row (metrics rows carry ``kind``, audit rows
    ``controller``/``inputs``)."""
    rows = _load_jsonl(path)
    if not rows:
        raise ValueError(f"{path}: empty dump")
    if "kind" in rows[0]:
        return _summarize_metrics(rows)
    if "controller" in rows[0] or "inputs" in rows[0]:
        return _summarize_audit(rows)
    raise ValueError(f"{path}: rows look like neither metrics nor audit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--validate-trace", action="append", default=[],
                    help="trace_event JSON file(s) to schema-check "
                         "(TRACE_*.json and FLIGHT_*.json)")
    ap.add_argument("--validate-metrics", action="append", default=[],
                    help="metrics JSONL file(s) to schema-check")
    ap.add_argument("--assert-zero", action="append", default=[],
                    metavar="NAME",
                    help="fail unless counter NAME is present and 0 in "
                         "every --validate-metrics file")
    ap.add_argument("--summarize", action="append", default=[],
                    help="metrics/audit JSONL file(s) to pretty-print")
    args = ap.parse_args(argv)
    ok = True
    for path in args.validate_trace:
        try:
            n = validate_trace_file(path)
            print(f"OK {path}: {n} trace events")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            ok = False
    for path in args.validate_metrics:
        try:
            n = validate_metrics_file(path)
            print(f"OK {path}: {n} metric rows")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            ok = False
        for name in args.assert_zero:
            try:
                assert_zero(path, name)
                print(f"OK {path}: {name} == 0")
            except (OSError, ValueError, json.JSONDecodeError) as e:
                print(f"FAIL {path}: {e}", file=sys.stderr)
                ok = False
    if args.assert_zero and not args.validate_metrics:
        print("FAIL --assert-zero requires --validate-metrics",
              file=sys.stderr)
        ok = False
    for path in args.summarize:
        try:
            print(f"== {path}")
            print(summarize_file(path))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

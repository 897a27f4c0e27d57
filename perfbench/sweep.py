"""The knee of an open-loop cell: its traffic at each of a few fixed rates.

    python3 perfbench/sweep.py --workload <cell> --seconds <s> \\
        --rates <r> [<r> ...] [--seed <n>]

For each rate, one run of the cell with its ``rate_per_s`` set to it (a
copy of the benchmark's data under ``build/perfbench_sweep``): the
requests due in the window, those failed, the p95 latency from due time,
and the backlog (requests due and not yet admitted) at the middle and at
the end of the window. The knee is the highest rate whose backlog does
not grow; the cell runs at four fifths of it. One JSON line a rate.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def backlog(recs, t: float) -> int:
    return sum(1 for r in recs if r.due <= t and not (
        r.req is not None and 0 < r.req.service_start <= t))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import harness
    from perfbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    root = ROOT / "build" / "perfbench_sweep"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "perfbench", root / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for rate in args.rates:
        (root / "perfbench" / "cells" / f"{args.workload}.json").write_text(
            json.dumps(dict(cell.geometry, rate_per_s=rate)))
        t0 = time.perf_counter()
        res = harness.run(args.workload, args.seed, args.seconds, False,
                          t_start=t0, root=root,
                          after_check=lambda data, **kw: {"data": data})
        d = res["extra"]["data"]
        mid = d.w0 + d.seconds / 2
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "attempted": res["attempted"], "failed": res["failed"],
            "correct": res["correct"],
            "p95_latency_ms": res["metrics"].get("p95_latency_ms",
                                                 {}).get("value"),
            "backlog_mid": backlog(d.recs, mid),
            "backlog_end": backlog(d.recs, d.w1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings the limits of ``correct`` are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <k>] [--fault <name>] \\
        [--out <file>]

For each seed, in one process: a run of the cell as the benchmark makes it
(set-up, a window of ``--seconds``, the drain), the program's widest gap
(the lower reading, over a dozen seeds or more), and on the first
``--control-seeds`` seeds the control's: the reference computed with every
product in float8 e4m3, the precision below the configurations' bfloat16,
at each position of the same sampled prompts and served tokens, the gap of
the token it puts first (the upper reading, its smallest over three seeds
or more). The control's numbers are judged against the cell's limits by
the harness's own ``check.judge`` (``control_correct``, which has to come
out false). Beside each widest gap, the mean gap, the 99th percentile and
the share of tokens off the reference's argmax. With ``--fault`` the
program runs with that fault of ``faults.py`` planted, at the cell's own
size, and ``correct`` has to come out false. One JSON line a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def stats(g) -> dict:
    """Widest, mean and 99th-percentile gap, and the share of tokens whose
    gap is not 0 (the served token is not the reference's argmax)."""
    import torch
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)),
            "off": float((g > 0).float().mean())}


def readings(control: bool, limits: dict):
    from perfbench import check

    def after(data, model, params, group, prompt_len, got):
        out = {"program": got["max_logit_gap"],
               "tokens": got["tokens_compared"],
               "program_stats": stats(check.gaps(model, params, group,
                                                 prompt_len))}
        if control:
            g = check.gaps(model, params, group, prompt_len, quant="fp8")
            out["control"] = float(g.max())
            out["control_stats"] = stats(g)
            judged = check.judge({"max_logit_gap": float(g.max()),
                                  "mean_logit_gap": float(g.mean()),
                                  "tokens_compared": int(len(g))}, limits)
            out["control_correct"] = all(j["ok"] for j in judged.values())
            out["control_checks"] = {k: j["value"]
                                     for k, j in judged.items()}
        return out
    return after


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", default="", help="plant this fault of "
                    "perfbench/faults.py in the program")
    ap.add_argument("--out", default="")
    ap.add_argument("--root", default=str(ROOT),
                    help="a benchmark root (BENCHMARK.json and perfbench's "
                         "data folders) other than this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import faults, harness
    from perfbench.spec import load_cell
    limits = load_cell(args.workload, Path(args.root)).geometry["limits"]
    lines = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            res = harness.run(
                args.workload, seed, args.seconds, False, t_start=t0,
                root=Path(args.root),
                after_check=readings(i < args.control_seeds, limits))
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault or None, "correct": res["correct"],
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "attempted": res["attempted"], "failed": res["failed"],
                **res["extra"], "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A cell is added by data files alone: the smoke root adds three cells
(configurations, mixes, cell files and entries of BENCHMARK.json) and no
file of the benchmark's code or data is edited; each reports the metrics
BENCHMARK.json gives it."""
import hashlib
import json
import time

from perfbench import harness
from perfbench.spec import ROOT, load_cell
from perfbench.tests.smoke import make_root

BENCH = ROOT / "perfbench"


def _digest():
    h = hashlib.sha256()
    for p in sorted([ROOT / "BENCHMARK.json"] + [
            p for p in BENCH.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts]):
        h.update(str(p.relative_to(ROOT)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def test_cells_added_by_data_files_alone_run(tmp_path):
    before = _digest()
    root = make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for cell in ("smoke-moe.saturate", "smoke-moe.steady"):
        c = load_cell(cell, root)
        e2e = {m["name"] for m in c.end_to_end}
        for trace in (False, True):
            out = harness.run(cell, 4, 1.0, trace,
                              t_start=time.perf_counter(), root=root,
                              device="cpu", log=lambda m: None)
            assert out["correct"]
            got = set(out["metrics"])
            if not trace:
                assert got == e2e and "setup_s" in got
            else:
                # the readers that need no device trace read something
                assert got and got <= {m["name"] for m in c.per_layer}
                assert all(v["value"] > 0 for v in out["metrics"].values())
    assert _digest() == before
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))


def test_every_metric_and_cell_has_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", ()):
            c = load_cell(w)
            assert m["moves"] in {e["name"] for e in c.end_to_end}
    for w in spec["workloads"]:
        c = load_cell(w["name"])
        assert {"setup_s"} < {m["name"] for m in c.end_to_end}
        assert c.per_layer
        assert set(c.geometry["limits"]) >= {"tokens_compared"}
    assert all(harness.E2E.get(m["name"]) for m in spec["end_to_end"])

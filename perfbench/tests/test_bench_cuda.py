"""On the card: a cell's run through ``run.py`` at its own size; the
control, judged by the harness's ``check.judge`` against the cell's
limits, not correct there; and a planted fault at a cell's own size not
correct. All skip without a card
(``python -m pytest -m cuda perfbench/tests/test_bench_cuda.py``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["granite-moe.saturate", "internvl2-26b.saturate",
         "granite-moe.steady"]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "perfbench/control.py", "--workload", cell,
         "--seconds", "6", "--seeds", str(2**31 + 11), "--control-seeds",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = json.loads((ROOT / "perfbench" / "cells" / f"{cell}.json")
                        .read_text())["limits"]
    assert line["correct"]
    assert line["control_correct"] is False
    assert any(line["control_checks"][k] > lim
               for k, lim in limits.items() if k.endswith("logit_gap"))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["state-unchanged", "half-batch",
                                   "token-altered"])
def test_a_fault_at_the_cells_size_is_not_correct(fault):
    _card()
    out = subprocess.run(
        [sys.executable, "perfbench/control.py", "--workload",
         "granite-moe.saturate", "--seconds", "6", "--seeds",
         str(2**31 + 13), "--control-seeds", "0", "--fault", fault],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["fault"] == fault and line["correct"] is False

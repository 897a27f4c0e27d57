"""The port's training launchers in subprocesses, on the CPU (``--device
cpu``, few steps, one thread): ``launch.train`` with checkpoints and a
resume ("resumed from step"), and a resume of the port's checkpoints by
the reference's ``repro.launch.train``; ``launch.train_tiny_lm`` and
``launch.train_forecaster`` print the reference examples' lines (the same
header lines, the same line shapes for the numbers)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_parity  # noqa: F401  (thread limit)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
STEP = re.compile(r"^step +\d+ loss \d+\.\d{4} lr \d\.\d{2}e[-+]\d\d$")


def _run(*args, timeout=240):
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_train_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _run("-m", "repro_torch.launch.train", "--device", "cpu",
                 "--steps", "4", "--seq", "32", "--batch", "4",
                 "--ckpt-dir", ck, "--ckpt-every", "2")
    assert first.splitlines()[0] == ("tinyllama-1.1b-smoke: 2.9M params, "
                                     "microbatches=1")
    assert len(_lines(first, "step ")) == 4
    assert all(STEP.match(ln) for ln in _lines(first, "step "))
    assert re.search(r"^4 steps in [\d.]+s \(\d+ tok/s\), final loss "
                     r"\d+\.\d{4}$", first, re.M)
    assert sorted(os.listdir(ck)) == ["step_000000001", "step_000000003"]
    again = _run("-m", "repro_torch.launch.train", "--device", "cpu",
                 "--steps", "2", "--seq", "32", "--batch", "4",
                 "--ckpt-dir", ck, "--ckpt-every", "2")
    assert "resumed from step 3" in again
    assert [ln.split()[1] for ln in _lines(again, "step ")] == ["4", "5"]
    assert sorted(os.listdir(ck)) == ["step_000000001", "step_000000003",
                                      "step_000000005"]
    # the reference's launcher resumes from the port's checkpoints
    ref = _run("-m", "repro.launch.train", "--steps", "1", "--seq", "32",
               "--batch", "4", "--ckpt-dir", ck)
    assert "resumed from step 5" in ref


def test_train_microbatches_flag():
    out = _run("-m", "repro_torch.launch.train", "--device", "cpu",
               "--steps", "2", "--seq", "16", "--batch", "4",
               "--microbatches", "2")
    assert out.splitlines()[0].endswith("microbatches=2")
    assert len(_lines(out, "step ")) == 2


@pytest.mark.parametrize("launcher", ["train", "train_tiny_lm",
                                      "train_forecaster"])
def test_launchers_default_to_the_card(launcher):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = subprocess.run([sys.executable, "-m",
                          f"repro_torch.launch.{launcher}", "--steps", "1"],
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_train_tiny_lm_prints_the_example_lines():
    port = _run("-m", "repro_torch.launch.train_tiny_lm", "--device", "cpu",
                "--steps", "30", "--seq", "32")
    ref = _run("examples/train_tiny_lm.py", "--steps", "30", "--seq", "32")
    for out in (port, ref):
        lines = out.splitlines()
        assert lines[0] == "model: tinyllama-1.1b-smoke (2.9M params)"
        steps = _lines(out, "step ")
        assert [ln.split()[1] for ln in steps] == [
            "0", "3", "6", "9", "12", "15", "18", "21", "24", "27", "29"]
        assert all(re.match(r"^step +\d+ loss \d+\.\d{4} \|g\| \d+\.\d{3}$",
                            ln) for ln in steps)
        assert re.search(r"^30 steps in [\d.]+s \(\d+ tok/s\)$", out, re.M)
        assert re.search(r"^loss: \d+\.\d{3} -> \d+\.\d{3} "
                         r"\((learned|check lr)\)$", out, re.M)
    first = float(_lines(port, "step    0")[0].split()[3])
    last = float(_lines(port, "step   29")[0].split()[3])
    assert last < first


def test_train_forecaster_prints_the_example_lines():
    port = _run("-m", "repro_torch.launch.train_forecaster", "--device",
                "cpu", "--steps", "20", "--hours", "1")
    ref = _run("examples/train_forecaster.py", "--steps", "20", "--hours",
               "1")
    assert port.splitlines()[0] == ref.splitlines()[0] == \
        "trace: 3600s, train 2700s / test 900s"
    for out in (port, ref):
        assert re.search(r"^LSTM trained: loss \d+\.\d{4} -> \d+\.\d{4}$",
                         out, re.M)
        rows = [ln.split() for ln in out.splitlines()
                if ln.startswith(("LSTM (paper)", "MovingMax",
                                  "Ensemble(max)"))]
        assert len(rows) == 3
        assert all(r[-1].endswith("%") for r in rows)
    # MovingMax needs no training: its row is the reference's
    assert _lines(port, "MovingMax") == _lines(ref, "MovingMax")

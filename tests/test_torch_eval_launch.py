"""The port's evaluation launchers against the reference's examples, each
run in a subprocess: ``launch.quickstart`` prints the text of
``examples/quickstart.py``; ``launch.replay_trace`` prints the simulated
panels of ``examples/replay_twitter_trace.py`` and, with ``--engine
--device cpu``, serves the bursty trace on the port's engine;
``launch.llm_autoscale`` under the reference's TPU v5e constants prints the
numbers of ``examples/llm_autoscale_tpu.py``. Both sides run under one
``PYTHONHASHSEED``: the paper's ResNet profiles draw their noise from a
seed salted with ``hash(name)``, which Python randomises per process."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (thread limit)

ROOT = Path(__file__).resolve().parents[1]
# One intra-op thread in the launchers, as ``_torch_parity`` gives the
# in-process tests: the engine replay profiles its ladder live, and torch's
# default of a thread per core, on a host the other test workers load,
# slowed a smoke request past the launcher's 2000 ms SLO (so the
# controller served nothing) where one thread took ~30 ms.
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0",
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _start(*args):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def _both(port_args, ref_args):
    """Run the port's and the reference's command side by side."""
    procs = _start(*port_args), _start(*ref_args)
    return tuple(_finish(p) for p in procs)


def test_quickstart_prints_the_reference_text():
    port, ref = _both(["-m", "repro_torch.launch.quickstart"],
                      ["examples/quickstart.py"])
    assert "InfAdapter accuracy gain" in port
    assert port == ref


@pytest.fixture(scope="module")
def replays():
    """The port's launcher with its CPU engine replay beside the reference
    example's simulated panels. The loop's first decision loads a rung
    before any arrival, which takes seconds on a loaded host: the replay
    runs long enough that arrivals follow it."""
    return _both(["-m", "repro_torch.launch.replay_trace", "--engine",
                  "--device", "cpu", "--engine-seconds", "15"],
                 ["examples/replay_twitter_trace.py"])


def test_replay_trace_prints_the_reference_panels(replays):
    port, ref = replays
    panels = port[:port.index("\nreplaying bursty trace")]
    assert panels.count("=== ") == 2 and "VPA-resnet152" in panels
    assert panels == ref


def test_replay_trace_engine_serves_requests(replays):
    port, _ = replays
    lines = [ln for ln in port.splitlines()
             if ln.startswith("engine replay: ")]
    assert len(lines) == 1, port[port.index("\nreplaying"):]
    served, submitted = lines[0].split()[2].split("/")
    assert int(served) > 0 and int(submitted) >= int(served)
    assert "predicted=" in port             # the controller stepped


def _v5e_patch(argv):
    """Run ``llm_autoscale.main(argv)`` on the reference's TPU v5e
    constants."""
    return ("import repro_torch.core.profiles as p\n"
            "p.PEAK_FLOPS_BF16, p.HBM_BW = 197e12, 819e9\n"
            "from repro_torch.launch import llm_autoscale\n"
            f"llm_autoscale.main({argv!r})\n")


def _as_chips(port):
    return port.replace("H100 cards", "chips").replace("cards", "chips")


def test_llm_autoscale_equals_reference_under_v5e_constants():
    """The ladder's roofline on the reference's TPU v5e constants: the same
    profiles, trace and results, in cards where the reference says chips."""
    port, ref = _both(["-c", _v5e_patch(["--arch", "tinyllama-1.1b"])],
                      ["examples/llm_autoscale_tpu.py", "--arch",
                       "tinyllama-1.1b"])
    assert "H100 cards" in port and "th(4 cards)" in port
    assert _as_chips(port) == ref


def test_llm_autoscale_defaults_to_the_reference_examples_yi_6b():
    """With no ``--arch`` both sides take yi-6b: the same ladder text and
    results under the v5e constants."""
    port, ref = _both(["-c", _v5e_patch([])],
                      ["examples/llm_autoscale_tpu.py"])
    assert port.startswith("variant ladder for yi-6b (H100 cards as units)")
    assert "yi-6b-L32" in port
    assert _as_chips(port) == ref


def test_replay_trace_store_profiles(tmp_path):
    """``--store``: the ladder's profiles from a store saved by
    ``launch.profile_and_serve``, a missing rung refused by name."""
    from repro_torch.core.profiles import VariantProfile
    from repro_torch.launch.replay_trace import engine_ladder, stored_profiles
    from repro_torch.profiling.store import ProfileStore
    names = list(engine_ladder(full_width=False))
    assert names == ["tinyllama-1.1b-L2", "tinyllama-1.1b-L4"]
    store = ProfileStore(str(tmp_path / "p.json"))
    for i, n in enumerate(names):
        store.register(VariantProfile(name=n, accuracy=70.0 + i, rt=0.1,
                                      th_slope=5.0 - i, th_intercept=0.0,
                                      lat_base_ms=10.0, lat_k_ms=40.0),
                       "measured")
    path = store.save()
    got = stored_profiles(path, names)
    assert list(got) == names and got[names[1]].th_slope == 4.0
    with pytest.raises(KeyError, match="tinyllama-1.1b-L22"):
        stored_profiles(path, names + ["tinyllama-1.1b-L22"])


def test_replay_trace_engine_without_a_card_raises_before_the_panels():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import replay_trace
    lines = []
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_trace.main(["--engine"], log=lines.append)
    assert lines == []

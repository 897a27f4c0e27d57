"""The port stands alone: no JAX and nothing of the reference package is
imported by it, and its entry points refuse to run on the CPU unless asked."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (thread limit)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.M)


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout


def test_the_scan_covers_the_profiling_modules():
    assert {"repro_torch.profiling", "repro_torch.profiling.calibrate",
            "repro_torch.profiling.drift", "repro_torch.profiling.measure",
            "repro_torch.profiling.store",
            "repro_torch.launch.profile_and_serve"} <= set(MODULES)


def test_the_scan_covers_the_cluster_modules():
    assert {"repro_torch.cluster", "repro_torch.cluster.faults",
            "repro_torch.cluster.placement", "repro_torch.cluster.replicas",
            "repro_torch.cluster.router"} <= set(MODULES)
    assert {p.name for p in (PKG / "cluster").rglob("*.py")} == {
        "__init__.py", "faults.py", "placement.py", "replicas.py",
        "router.py"}


def test_the_scan_covers_the_evaluation_modules():
    assert {"repro_torch.sim.cluster", "repro_torch.sim.runner",
            "repro_torch.data", "repro_torch.data.traces",
            "repro_torch.analysis.report", "repro_torch.core.infaas",
            "repro_torch.core.cocktail", "repro_torch.launch.quickstart",
            "repro_torch.launch.replay_trace",
            "repro_torch.launch.llm_autoscale"} <= set(MODULES)
    assert {p.name for p in (PKG / "sim").rglob("*.py")} == {
        "cluster.py", "runner.py"}


def test_the_scan_covers_the_moe_modules():
    assert {"repro_torch.models.moe",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.qwen3_moe_235b_a22b"} <= set(MODULES)


def test_the_scan_covers_the_training_modules():
    assert {"repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.data.tokens",
            "repro_torch.core.forecaster", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.launch.train_tiny_lm",
            "repro_torch.launch.train_forecaster"} <= set(MODULES)
    assert {p.name for p in (PKG / "train").rglob("*.py")} == {
        "__init__.py", "optimizer.py", "checkpoint.py"}


def test_the_scan_covers_the_dryrun_modules():
    """Every module of the reference has its counterpart: the roofline,
    the sharding policy and context, the production mesh and the dry
    run."""
    assert {"repro_torch.analysis.roofline", "repro_torch.sharding.policy",
            "repro_torch.sharding.context", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun"} <= set(MODULES)
    ref = ROOT / "src" / "repro"
    skip = {"kernels/ref.py", "kernels/paged/__init__.py",
            "kernels/paged/decode.py"}   # the tests' oracle; paged_decode.py
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if str(p.relative_to(ref)) not in skip
                     and p.name != "__init__.py"
                     and not (PKG / p.relative_to(ref)).exists())
    assert missing == [], missing


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_has_no_jax_or_reference_import(path):
    assert not FORBIDDEN.search(path.read_text()), path


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")


def test_engine_without_device_raises_without_a_card():
    _no_card()
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.serving.engine import InProcessServingEngine
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        InProcessServingEngine({"a": (cfg, 70.0)})


def test_backend_without_device_raises_without_a_card():
    _no_card()
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.serving.engine import VariantBackend
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        VariantBackend("a", cfg, 70.0)


def test_serve_main_defaults_to_the_card():
    _no_card()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--seconds", "1"])


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(alone, tmp_path):
    _no_card()
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

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

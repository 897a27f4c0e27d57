"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``repro_torch`` is the program, ``repro`` the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not (_top_level_imports(p) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert not (_top_level_imports(p) & (FORBIDDEN | {"repro_torch"})), p
    code = ("import sys; import perfbench.reference.lm, perfbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not (loaded & (FORBIDDEN | {"repro_torch"})), loaded


def test_the_run_check_compares_top_level_names_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.serving", "reprox",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.jax_loaded() == ["jax", "repro"]


def test_a_cells_run_loads_no_jax(tmp_path):
    code = ("import sys, time; sys.path[:0] = ['.', 'src']\n"
            "from pathlib import Path\n"
            "from perfbench.tests.smoke import make_root\n"
            "from perfbench import harness\n"
            f"root = make_root(Path({str(tmp_path)!r}))\n"
            "harness.run('smoke-moe.saturate', 3, 0.5, False, "
            "t_start=time.perf_counter(), root=root, device='cpu', "
            "log=lambda m: None)\n"
            "print(harness.jax_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "PYTHONPATH": ""}).stdout
    assert out.strip().splitlines()[-1] == "[]"

"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/repro_torch/<key>/`` under the
repository root (``.gitignore`` lists ``build/``), where ``<key>`` hashes
the sources and flags: an edited source rebuilds, an unchanged one loads.
All sources build in parallel, one ``nvcc`` each. Nothing here runs at
import time: the CPU tests import this module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_prefill", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}   # process-wide: one load per library


def build_root() -> Path:
    """``build/repro_torch`` beside ``src/`` (the repository root)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from csrc/ at first use")


def lib_dir() -> Path:
    return build_root() / _key()


def ensure_built() -> Dict[str, Path]:
    """Compile every missing library (all ``nvcc`` processes started
    together) and return name -> library path. ``<name>.log`` beside each
    library keeps the compiler's report (``-Xptxas -v``: registers, shared
    memory, spills per kernel)."""
    out = lib_dir()
    libs = {n: out / f"lib{n}.so" for n in SOURCES}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        (out / f"{n}.log").write_text(log)
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[n])      # atomic: readers never see half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building it first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(ensure_built()[name]))
    return lib


def build_log(name: str) -> str:
    """The compiler's report for ``name`` from its last build ('' if none)."""
    p = lib_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


# ------------------------------------------------------------ launch helpers
# dtype codes of the C interfaces (csrc/common.cuh)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_operand(name: str, t, device, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``ndim``-d
    ``dtype`` tensor on ``device`` — what the kernels' vector loads need."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_launch(name: str, err: int) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")

"""Mamba-2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu``
(replacing the TPU kernel ``repro/kernels/ssd_scan.py:ssd_scan_chunked``)
beside its plain PyTorch version (``models.ssd.ssd_scan_plain``, the
reference's ``ssd_chunked`` over a zero-padded sequence).

``ssd_scan_chunked`` is the wrapper: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. ``ssd_scan_chunked.launches``
counts wrapper calls that launched (never plain-version calls); each such
call makes three CUDA launches (chunk states and C.B, the state pass, the
outputs; ``launch_plan``). Unlike the TPU kernel, any sequence length
works: the kernel masks a ragged last chunk, so the model passes its
unpadded views.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models.ssd import ssd_scan_plain

_C, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_C] * 9 + [_I] * 6 + [_L] * 4 + [_I, _C]
DEFAULT_CHUNK = 128
HEAD_DIMS = (16, 32, 64)           # p, instantiated in csrc/ssd_scan.cu
STATE_DIMS = (8, 16, 32, 64, 128)  # n, likewise
MAX_CHUNK = 128                 # csrc kQMax
MAX_SMEM_BYTES = 232_448        # dynamic shared memory of one H100 block
THREADS = 256                   # csrc kThreads
_TILE_ROWS = 32                 # csrc kTR


def _pad16(q: int) -> int:
    return -(-q // 16) * 16


def launch_plan(b: int, s: int, h: int, p: int, n: int, chunk: int,
                dtype: str) -> Dict:
    """The three launches of one call (csrc ``launch``): grids (x, y, z),
    threads, dynamic shared memory bytes (csrc ``*_smem_*``), and the
    workspace floats (chunk states (b, nc, h, p, n), C.B (b, nc, QP, QP)
    with QP the chunk rounded up to 16, chunk decays (b, nc, h))."""
    q, qp, nc = chunk, _pad16(chunk), -(-s // chunk)
    if dtype == "torch.bfloat16":
        ld = _pad16(n) + 8       # bf16 rows of n: zero to 16, then the skew
        smem1 = 2 * qp * (ld + max(ld, p + 8)) + 4 * 3 * qp
        smem3 = 2 * (qp * ld + 2 * p * ld + qp * (p + 8)) + 8 * qp
    elif dtype == "torch.float32":
        smem1 = 4 * (q * (n + 1) + q * max(p, n + 1) + 3 * q)
        smem3 = 4 * (q * p + q * (n + 1) + p * (n + 1) + _TILE_ROWS * q
                     + 2 * q)
    else:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    pn4 = p * n // 4
    return {
        "launches": [
            {"kernel": "ssd_scan_chunk", "grid": (h + 1, nc, b),
             "threads": THREADS, "smem": smem1},
            {"kernel": "ssd_scan_pass",
             "grid": (-(-pn4 // THREADS), h, b), "threads": THREADS,
             "smem": 0},
            {"kernel": "ssd_scan_out", "grid": (h, nc, b),
             "threads": THREADS, "smem": smem3}],
        "workspace_floats": b * nc * (h * p * n + qp * qp + h),
    }


def _row_strides(name: str, t: torch.Tensor, device, dtype,
                 inner: Tuple[int, ...]) -> Tuple[int, int]:
    """Check a (b, s, *inner) operand whose inner dims are packed (each
    (b, s) row contiguous) and 16-byte aligned (its base and every stride
    that is stepped) and return its (batch, step) strides in elements."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 + len(inner) or tuple(t.shape[2:]) != inner:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"(b, s, {', '.join(map(str, inner))})")
    want = 1
    for size, stride in reversed(list(zip(t.shape[2:], t.stride()[2:]))):
        if size > 1 and stride != want:
            raise ValueError(f"{name} must be packed within a (b, s) row")
        want *= size
    esz = t.element_size()
    if t.data_ptr() % 16 or any(size > 1 and stride * esz % 16
                                for size, stride in zip(t.shape[:2],
                                                        t.stride()[:2])):
        raise ValueError(f"{name} must be 16-byte aligned: base and (b, s) "
                         f"row strides (cp.async rows), got strides "
                         f"{tuple(t.stride()[:2])}")
    return t.stride(0), t.stride(1)


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor,
               initial_state: Optional[torch.Tensor], chunk: int) -> Dict:
    """Raise on what the kernel does not take (before any launch); return
    the sizes, strides and ``launch_plan`` of the call."""
    dev, xdt = x.device, x.dtype
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, h, p), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    x_st = _row_strides("x", x, dev, xdt, (h, p))
    bc_st = _row_strides("B", B, dev, xdt, (n,))
    if _row_strides("C", C, dev, xdt, (n,)) != bc_st or \
            tuple(C.shape[:2]) != (b, s) or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"share x's (b, s) and their strides")
    build.check_operand("dt", dt, dev, torch.float32, 3, aligned=False)
    build.check_operand("A", A, dev, torch.float32, 1, aligned=False)
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if initial_state is not None:
        build.check_operand("initial_state", initial_state, dev,
                            torch.float32, 4)
        if initial_state.shape != (b, h, p, n):
            raise ValueError(f"initial_state {tuple(initial_state.shape)}, "
                             f"expected {(b, h, p, n)}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan is built for p in {HEAD_DIMS} and n in "
                         f"{STATE_DIMS}, got p={p} n={n}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if b == 0 or s == 0 or h == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    plan = launch_plan(b, s, h, p, n, chunk, str(xdt))
    assert all(k["smem"] <= MAX_SMEM_BYTES for k in plan["launches"]), plan
    return {"shape": (b, s, h, p, n), "strides": (*x_st, *bc_st),
            "plan": plan}


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor,
                     initial_state: Optional[torch.Tensor] = None, *,
                     chunk: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p); dt (b,s,h) fp32; A (h,) fp32; B, C (b,s,n) in x's
    dtype; initial_state (b,h,p,n) fp32 or None (zeros) -> (y (b,s,h,p) in
    x's dtype, final state (b,h,p,n) fp32). x, B and C may be strided views
    whose (b, s) rows are packed and 16-byte aligned; dt, A and the state
    must be contiguous."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk, initial_state)
    args = check_args(x, dt, A, B, C, initial_state, chunk)
    b, s, h, p, n = args["shape"]
    dev = x.device
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    init_ptr = None if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, _ = build.workspace(dev, stream, args["plan"]["workspace_floats"],
                                0)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), init_ptr, y.data_ptr(), final.data_ptr(),
                 ws.data_ptr(), b, s, h, p, n, chunk, *args["strides"],
                 build.dtype_code(x), stream)
    build.check_launch("ssd_scan", err)
    ssd_scan_chunked.launches += 1
    return y, final


ssd_scan_chunked.launches = 0

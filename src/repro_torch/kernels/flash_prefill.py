"""Causal GQA flash attention for prefill: the CUDA kernel
``csrc/flash_prefill.cu`` (replacing the TPU kernel
``repro/kernels/flash_prefill.py:flash_prefill_bkhd``) and its plain
PyTorch version.

``flash_prefill_bshd`` is the wrapper, in the model layout (B,S,H,hd): the
TPU wrapper's relayout to (B,KV,G,S,hd) and padding of S exist only for
the TPU's tiling and are gone. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. ``flash_prefill_bshd.launches`` counts
kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, _C]
HEAD_DIMS = (64, 128)           # instantiated in csrc/flash_prefill.cu
NEG_INF = -1e30


def causal_window_mask(S: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j visible to query i (j <= i, and i - window < j
    when window > 0)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window > 0:
        ok &= j > i - window
    return ok


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, softcap: float = 0.0
                        ) -> torch.Tensor:
    """q (B,S,H,hd); k, v (B,S,KV,hd) -> (B,S,H,hd). fp32 math: scores x
    1/sqrt(hd), softcap, causal/window mask (-1e30), softmax, @ v."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~causal_window_mask(S, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_prefill_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int = 0, softcap: float = 0.0
                       ) -> torch.Tensor:
    """q (B,S,H,hd); k, v (B,S,KV,hd) -> (B,S,H,hd). Causal (+window)."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, softcap=softcap)
    dev, dt = q.device, q.dtype
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(name, t, dev, dt, 4)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV or S == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill is built for hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, hd, window, float(softcap),
                 build.dtype_code(q), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_prefill", err)
    flash_prefill_bshd.launches += 1
    return out


flash_prefill_bshd.launches = 0

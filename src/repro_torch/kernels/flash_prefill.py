"""Causal GQA flash attention for prefill: the CUDA kernel
``csrc/flash_prefill.cu`` (replacing the TPU kernel
``repro/kernels/flash_prefill.py:flash_prefill_bkhd``) and its plain
PyTorch version.

``flash_prefill_bshd`` is the wrapper, in the model layout (B,S,H,hd): the
TPU wrapper's relayout to (B,KV,G,S,hd) and padding of S exist only for
the TPU's tiling and are gone. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. The kernel dispatches on dtype and
head size (``launch_plan`` mirrors it): bf16 runs its products on the
tensor cores with fp32 accumulation (``wgmma`` with the pipelined kernel:
at hd 64 one head a CTA and four CTAs an SM, at hd 128 one head a CTA, at
hd 256 two heads a CTA; ``mma.sync`` at hd 32), fp32 keeps fp32 products
on the CUDA cores.
``flash_prefill_bshd.launches`` counts kernel launches (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, _C]
HEAD_DIMS = (32, 64, 128, 256)  # instantiated in csrc/flash_prefill.cu
NEG_INF = -1e30
MAX_SMEM_BYTES = 232_448        # dynamic shared memory of one H100 block
SM_SMEM_BYTES = 233_472         # shared memory of one H100 SM (228 KB)
SM_THREADS = 2048               # resident threads of one H100 SM
BQ = 64                         # query rows of a CTA, keys of a K/V tile
WG_TILE = 64 * 128              # bytes of one swizzled 64 x 64 bf16 tile


def launch_plan(hd: int, dtype: torch.dtype) -> Tuple[str, int, int]:
    """(kernel, threads, query heads a CTA) of one launch, as
    ``flash_prefill_launch`` dispatches: bf16 at hd 64, 128 and 256 on the
    pipelined ``wgmma`` kernel, one warpgroup a query head: one head a CTA
    at hd 64 (four CTAs an SM, each step's PV and QK^T waited for together
    before its softmax) and at
    hd 128 (two CTAs an SM, softmax under the previous tile's PV), two
    heads of a KV head a CTA at hd 256 (the grid has KV * ceil(G / 2) CTAs
    along the heads); bf16 at hd 32 on ``mma.sync``; fp32 on the CUDA
    cores."""
    if dtype == torch.bfloat16:
        if hd in (64, 128):
            return "flash_prefill_wide_kernel", 128, 1
        if hd == 256:
            return "flash_prefill_wide_kernel", 256, 2
        return "flash_prefill_mma_kernel", 128, 1
    return "flash_prefill_simt_kernel", 128, 1


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA of ``launch_plan``'s kernel: the
    pipelined ``wgmma`` kernel a swizzled Q tile per head (hd / 64
    sub-tiles) and two-tile K and V rings, plus 1024 bytes of alignment;
    ``mma.sync`` five tiles in rows of hd + 8 bf16; fp32 Q^T, K^T, V and
    P^T tiles."""
    kernel, _, heads = launch_plan(hd, dtype)
    if kernel == "flash_prefill_simt_kernel":
        return 4 * (3 * hd * BQ + BQ * BQ)
    if kernel == "flash_prefill_mma_kernel":
        return 5 * BQ * (hd + 8) * 2
    return (heads + 4) * (hd // 64) * WG_TILE + 1024


def ctas_per_sm(hd: int, dtype: torch.dtype) -> int:
    """CTAs an SM that the launch bounds of ``launch_plan``'s kernel ask
    for (``wide_min_ctas`` in csrc/flash_prefill.cu): the pipelined kernel
    four at hd 64 and two at hd 128, one two-head CTA at hd 256; the
    others one."""
    kernel, _, heads = launch_plan(hd, dtype)
    if kernel != "flash_prefill_wide_kernel" or heads != 1:
        return 1
    return 4 if hd == 64 else 2


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


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int) -> None:
    """Raise on what the kernel does not take, before any launch: q
    (B,S,H,hd), k and v (B,S,KV,hd) of q's dtype, contiguous, 16-byte
    aligned and on q's device, with S > 0, H a multiple of KV, hd in
    ``HEAD_DIMS`` and an int window >= 0."""
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


def flash_prefill_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int = 0, softcap: float = 0.0
                       ) -> torch.Tensor:
    """q (B,S,H,hd); k, v (B,S,KV,hd) -> (B,S,H,hd). Causal (+window)."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, softcap=softcap)
    check_args(q, k, v, window)
    dev = q.device
    B, S, H, hd = q.shape
    KV = k.shape[2]
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

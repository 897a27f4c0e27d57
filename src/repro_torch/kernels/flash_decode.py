"""One-token GQA decode attention over a dense KV cache: the CUDA kernel
``csrc/flash_decode.cu`` (replacing the TPU kernel
``repro/kernels/flash_decode.py:flash_decode_bkhd``) and its plain PyTorch
version.

``flash_decode_bkhd`` is the wrapper: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. ``flash_decode_bkhd.launches``
counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _C]
MAX_GROUP_WIDTH = 4096          # G * hd accumulators per CTA (csrc kMaxAcc)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, *, softcap: float = 0.0
                       ) -> torch.Tensor:
    """q (B,KV,G,hd); k, v (B,KV,C,hd); bias (B,C) additive -> like q.
    fp32 math: scores x 1/sqrt(hd), softcap, + bias, softmax, @ v."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bkth->bkgh", p, v.float()).to(q.dtype)


def flash_decode_bkhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, *, softcap: float = 0.0
                      ) -> torch.Tensor:
    """q (B,KV,G,hd); k, v (B,KV,C,hd); bias (B,C) float32 -> like q.
    Any C: the kernel masks the ragged tail itself (nothing is padded)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias, softcap=softcap)
    dev, dt = q.device, q.dtype
    B, KV, G, hd = q.shape
    for name, t, tdt, nd in (("q", q, dt, 4), ("k", k, dt, 4), ("v", v, dt, 4),
                             ("bias", bias, torch.float32, 2)):
        build.check_operand(name, t, dev, tdt, nd)
    C = k.shape[2]
    if k.shape != (B, KV, C, hd) or v.shape != k.shape or \
            bias.shape != (B, C) or C == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(bias.shape)}")
    if hd % 8 or G * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"flash_decode needs hd % 8 == 0 and G*hd <= "
                         f"{MAX_GROUP_WIDTH}, got G={G} hd={hd}")
    lib = build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, KV, G, C, hd, float(softcap),
                 build.dtype_code(q), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_decode", err)
    flash_decode_bkhd.launches += 1
    return out


flash_decode_bkhd.launches = 0

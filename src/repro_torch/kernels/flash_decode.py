"""One-token GQA decode attention over a dense KV cache: the CUDA kernel
``csrc/flash_decode.cu`` (replacing the TPU kernel
``repro/kernels/flash_decode.py:flash_decode_bkhd``) and its plain PyTorch
version.

``flash_decode_bkhd`` is the wrapper: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. One launch splits the cache axis
over ``SPLITS`` CTAs per (b, kv-head); each writes its partial softmax
sums to a scratch workspace and the last to arrive combines them, counted
on a per-(b, kv-head) arrival counter that it leaves at zero. The
workspace (partials and counters, ``build.workspace``) is allocated once
per device and stream and shared with paged_decode: launches on one stream
run in order, so they never share it while in flight.
``flash_decode_bkhd.launches`` counts kernel launches (never plain-version
calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _C]
MAX_GROUP_WIDTH = 4096          # G * hd accumulators per CTA (csrc kMaxAcc)
SPLITS = 8                      # CTAs per (b, kv-head) (csrc kSplits)
MAX_SMEM_BYTES = 232_448        # dynamic shared memory of one H100 block


def smem_bytes(G: int, hd: int, esize: int) -> int:
    """Dynamic shared memory of one CTA for elements of ``esize`` bytes
    (csrc ``smem_bytes``): the K ring (rows padded by 16 bytes) and the V
    ring, two tiles of 128 (bf16) or 64 (fp32) positions each, then in
    fp32 the biases of both tiles, q, the tile's probabilities and
    (m, l, alpha)."""
    rows = 128 if esize == 2 else 64
    return (esize * 2 * rows * (2 * hd + 16 // esize)
            + 4 * (2 * rows + G * hd + G * rows + 3 * G))


def _launch_fn():
    """The kernel's C entry point, its argument types set once."""
    fn = build.load("flash_decode").flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


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
    smem = smem_bytes(G, hd, q.element_size())
    if hd % 8 or G * hd > MAX_GROUP_WIDTH or smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_decode needs hd % 8 == 0, G*hd <= "
                         f"{MAX_GROUP_WIDTH} and {smem} bytes of shared "
                         f"memory <= {MAX_SMEM_BYTES}, got G={G} hd={hd}")
    fn = _launch_fn()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, arrivals = build.workspace(
        dev, stream, B * KV * SPLITS * (G * hd + 2 * G), B * KV)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(), B, KV,
            G, C, hd, float(softcap), build.dtype_code(q), stream)
    # The decode step calls this once per layer and is bound by host time:
    # switch devices only when the call needs it.
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    build.check_launch("flash_decode", err)
    flash_decode_bkhd.launches += 1
    return out


flash_decode_bkhd.launches = 0

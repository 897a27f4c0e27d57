"""Public attention-kernel entry points, in the layouts of
``repro/kernels/ops.py``, plus the launch counters of every kernel.

The reference wrappers relayout and pad for the TPU's tiling; here a
kernel masks its own ragged edges, so only ``flash_decode`` (the
(B,1,H,hd)/(B,C,KV,hd) convenience form, off the serve path) still
relayouts, to the cache's native (B,KV,C,hd).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp

# kernel name -> the wrapper carrying its ``launches`` counter
WRAPPERS = {"flash_prefill": fp.flash_prefill_bshd,
            "flash_decode": fd.flash_decode_bkhd}


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd). Causal (+window)."""
    return fp.flash_prefill_bshd(q, k, v, window=window, softcap=softcap)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,1,H,hd); k,v: (B,C,KV,hd); bias: (B,C) -> (B,1,H,hd)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qk = q.reshape(B, KV, H // KV, hd)
    kk = k.transpose(1, 2).contiguous()                        # (B,KV,C,hd)
    vk = v.transpose(1, 2).contiguous()
    out = flash_decode_bkchd(qk, kk, vk, bias, softcap=softcap)
    return out.reshape(B, 1, H, hd)


def flash_decode_bkchd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, *, softcap: float = 0.0
                       ) -> torch.Tensor:
    """Kernel-native layout: q (B,KV,G,hd); k,v (B,KV,C,hd); bias (B,C)
    -> (B,KV,G,hd). Any C: the kernel masks the ragged tail itself."""
    return fd.flash_decode_bkhd(q, k, v, bias, softcap=softcap)


def launch_counts() -> Dict[str, int]:
    return {n: w.launches for n, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0

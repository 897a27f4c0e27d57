"""Public kernel entry points (attention and the SSD scan), in the layouts
of ``repro/kernels/ops.py``, plus the launch counters of every kernel.

The reference wrappers relayout and pad for the TPU's tiling; here a
kernel masks its own ragged edges, so only ``flash_decode`` (the
(B,1,H,hd)/(B,C,KV,hd) convenience form, off the serve path) still
relayouts, to the cache's native (B,KV,C,hd).

No kernel has a backward: the reference defines none (no ``custom_vjp``
under ``src/repro``), and its training path runs with ``use_pallas=False``.
So on CUDA tensors every entry point here raises where autograd would
need one (grad mode on and a floating input that requires grad), rather
than return an output whose inputs silently get no gradient; train with
``use_kernels=False``. On CPU tensors the plain versions run, and autograd
goes through them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import ssd_scan as ss

# kernel name -> the wrapper carrying its ``launches`` counter
WRAPPERS = {"flash_prefill": fp.flash_prefill_bshd,
            "flash_decode": fd.flash_decode_bkhd,
            "flash_decode_chunk": fd.flash_decode_chunk,
            "paged_decode": pd.paged_flash_decode_bkhd,
            "ssd_scan": ss.ssd_scan_chunked}


def _refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when ``name``'s kernel would launch on the card under autograd:
    grad mode on and a floating CUDA input that requires grad."""
    ts = [t for t in tensors if t is not None]
    if (torch.is_grad_enabled() and any(t.is_cuda for t in ts)
            and any(t.requires_grad and t.is_floating_point() for t in ts)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass (the reference "
            "defines no backward kernel); its inputs require grad, so their "
            "gradients would be lost. Training runs with use_kernels=False.")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd). Causal (+window)."""
    _refuse_autograd("flash_prefill", q, k, v)
    return fp.flash_prefill_bshd(q, k, v, window=window, softcap=softcap)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,1,H,hd); k,v: (B,C,KV,hd); bias: (B,C) -> (B,1,H,hd)."""
    _refuse_autograd("flash_decode", q, k, v, bias)
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
    _refuse_autograd("flash_decode", q, k, v, bias)
    return fd.flash_decode_bkhd(q, k, v, bias, softcap=softcap)


def flash_decode_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, *, softcap: float = 0.0
                       ) -> torch.Tensor:
    """Dense attention for ck query tokens per row in one call: q
    (B,ck,KV,G,hd); k,v (B,KV,C,hd); bias (B,ck,C) -> (B,ck,KV,G,hd), the
    stack over j of ``flash_decode_bkchd(q[:, j], k, v, bias[:, j])``. The
    operand rules are met here: q and bias contiguous, bias fp32 (no-ops
    on the model's own tensors)."""
    _refuse_autograd("flash_decode_chunk", q, k, v, bias)
    return fd.flash_decode_chunk(q.contiguous(), k, v,
                                 bias.float().contiguous(), softcap=softcap)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, *, softcap: float = 0.0
                       ) -> torch.Tensor:
    """Paged decode in kernel-native layout: q (B,KV,G,hd); k/v_pages
    (KV,P,page_size,hd); tables (B,n_pages) page ids; lengths (B,) live
    tokens -> (B,KV,G,hd). The pool is the stored cache layout and is never
    copied. This is where the kernel's operand rules are met: q is made
    contiguous, and tables and lengths of any integer dtype become int32
    (both no-ops when already so, which keeps a column slice of the
    engine's int32 table a view: the kernel takes its row stride)."""
    _refuse_autograd("paged_decode", q, k_pages, v_pages)
    return pd.paged_flash_decode_bkhd(q.contiguous(), k_pages, v_pages,
                                      tables.to(torch.int32),
                                      lengths.to(torch.int32),
                                      softcap=softcap)


def paged_flash_decode_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor, *, softcap: float = 0.0
                             ) -> torch.Tensor:
    """Paged attention for ck query tokens per row in one call: q
    (B,ck,KV,G,hd); k/v_pages (KV,P,page_size,hd); tables (B,n_pages);
    lengths (B,ck) live tokens per query -> (B,ck,KV,G,hd), the stack over
    j of ``paged_flash_decode(q[:, j], ..., lengths[:, j])``. The operand
    rules are met as there: q and lengths contiguous, tables and lengths
    int32 (no-ops when already so)."""
    _refuse_autograd("paged_decode", q, k_pages, v_pages)
    return pd.paged_flash_decode_chunk(q.contiguous(), k_pages, v_pages,
                                       tables.to(torch.int32),
                                       lengths.to(torch.int32).contiguous(),
                                       softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = ss.DEFAULT_CHUNK,
             initial_state: Optional[torch.Tensor] = None):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B,C: (b,s,n) -> (y, final state
    (b,h,p,n) fp32). ``initial_state=None`` means zeros. Any s: where the
    reference pads s to a chunk multiple, the kernel masks the ragged last
    chunk. This is where the kernel's operand rules are met: dt, A and the
    state become fp32 and contiguous (no-ops on the model's own tensors;
    a slice along s of dt is not contiguous), while x, B and C go in as
    strided views."""
    _refuse_autograd("ssd_scan", x, dt, A, B, C, initial_state)
    if initial_state is not None:
        initial_state = initial_state.float().contiguous()
    return ss.ssd_scan_chunked(x, dt.float().contiguous(),
                               A.float().contiguous(), B, C, initial_state,
                               chunk=chunk)


def launch_counts() -> Dict[str, int]:
    return {n: w.launches for n, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def add_launch_counts(counts: Mapping[str, int]) -> None:
    """Add per-kernel launches made outside the wrappers: a graph replay
    runs the launches its capture recorded."""
    for n, c in counts.items():
        WRAPPERS[n].launches += c

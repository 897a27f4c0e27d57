"""One-token GQA decode attention through a block table into a shared KV
page pool: the CUDA kernel ``csrc/paged_decode.cu`` (replacing the TPU
kernel ``repro/kernels/paged/decode.py:paged_flash_decode_bkhd``) and its
plain PyTorch version.

``paged_flash_decode_bkhd`` is the wrapper: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
``paged_flash_decode_bkhd.launches`` counts kernel launches (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _C]
MAX_GROUP_WIDTH = 4096          # G * hd accumulators per CTA (csrc kMaxAcc)
MAX_SMEM_BYTES = 232_448        # dynamic shared memory of one H100 block
_TILE = 64                      # positions per shared-memory tile (csrc kBK)


def smem_bytes(G: int, hd: int) -> int:
    """Dynamic shared memory of one launch (csrc ``smem_bytes``)."""
    return 4 * (_TILE + G * hd + _TILE * (hd + 1) + _TILE * hd + G * _TILE
                + 3 * G)


def paged_flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor, *, softcap: float = 0.0
                             ) -> torch.Tensor:
    """q (B,KV,G,hd); k/v_pages (KV,P,ps,hd); tables (B,n_pages) page ids;
    lengths (B,) live tokens -> like q. The semantics of the reference's
    oracle ``ref_paged_decode``: gather each row's pages into a dense
    (n_pages·ps) context, mask positions at or past the length, softmax in
    fp32; rows with length 0 give zeros. Masked positions are also zeroed
    in V before the product, so a poisoned (NaN) page past a row's length
    cannot reach its output, as in the kernel (identical for finite
    pools)."""
    B, KV, G, hd = q.shape
    ps = k_pages.shape[2]
    n_pages = tables.shape[1]
    T = n_pages * ps
    kg = k_pages[:, tables].movedim(1, 0).reshape(B, KV, T, hd).float()
    vg = v_pages[:, tables].movedim(1, 0).reshape(B, KV, T, hd).float()
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), kg) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                  # (B, T)
    s = torch.where(valid[:, None, None], s, -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1) * valid[:, None, None])
    vg = torch.where(valid[:, None, :, None], vg, 0.0)
    return torch.einsum("bkgt,bkth->bkgh", p, vg).to(q.dtype)


def paged_flash_decode_bkhd(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, tables: torch.Tensor,
                            lengths: torch.Tensor, *, softcap: float = 0.0
                            ) -> torch.Tensor:
    """q (B,KV,G,hd); k/v_pages (KV,P,ps,hd); tables (B,n_pages) int32;
    lengths (B,) int32 -> like q. ``tables`` may be a column slice of a
    wider table (its row stride is passed to the kernel; columns must be
    unit-stride). Only the entries covering each row's first
    ``min(length, n_pages·ps)`` positions are read; those must be page ids
    below P."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, tables,
                                        lengths, softcap=softcap)
    dev, dt = q.device, q.dtype
    B, KV, G, hd = q.shape
    for name, t, tdt, nd in (("q", q, dt, 4), ("k_pages", k_pages, dt, 4),
                             ("v_pages", v_pages, dt, 4)):
        build.check_operand(name, t, dev, tdt, nd)
    build.check_operand("lengths", lengths, dev, torch.int32, 1,
                        aligned=False)
    P, ps = k_pages.shape[1], k_pages.shape[2]
    if tables.device != dev or tables.dtype != torch.int32 or \
            tables.dim() != 2:
        raise ValueError(f"tables must be a 2-d int32 tensor on {dev}, got "
                         f"{tables.dtype} {tuple(tables.shape)} on "
                         f"{tables.device}")
    n_pages = tables.shape[1]
    if tables.stride(1) != 1 and n_pages > 1:
        raise ValueError("tables must have unit-stride columns")
    if k_pages.shape != (KV, P, ps, hd) or v_pages.shape != k_pages.shape \
            or tables.shape[0] != B or lengths.shape != (B,) or B == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)} tables "
                         f"{tuple(tables.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if hd % 8 or G * hd > MAX_GROUP_WIDTH or \
            smem_bytes(G, hd) > MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode needs hd % 8 == 0, G*hd <= "
                         f"{MAX_GROUP_WIDTH} and {smem_bytes(G, hd)} bytes "
                         f"of shared memory <= {MAX_SMEM_BYTES}, got G={G} "
                         f"hd={hd}")
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, KV,
                 G, P, ps, hd, n_pages, tables.stride(0), float(softcap),
                 build.dtype_code(q), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("paged_decode", err)
    paged_flash_decode_bkhd.launches += 1
    return out


paged_flash_decode_bkhd.launches = 0

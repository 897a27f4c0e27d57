"""GQA decode attention through a block table into a shared KV page pool:
the CUDA kernel ``csrc/paged_decode.cu`` (replacing the TPU kernel
``repro/kernels/paged/decode.py:paged_flash_decode_bkhd``) and its plain
PyTorch version, in two forms:

- ``paged_flash_decode_bkhd``: one query token per row (the decode step);
- ``paged_flash_decode_chunk``: ``ck`` query tokens per row with a length
  each (the fused tick's prefill chunk), defined as the stack over j of the
  single form at ``lengths[:, j]`` — the reference's per-token loop, in one
  launch.

Each is the wrapper of its form: CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. ``launch_plan`` picks its route
before any launch: the chunk form in bf16 at hd 64, 128 and 256 on the
tensor cores (``wgmma`` over blocks of 64 query rows), every other launch
on the CUDA cores. A launch splits each (b, kv-head, block of query rows)
over several CTAs along the positions; the last to arrive combines their
partials through the workspace that flash_decode uses
(``build.workspace``). Both forms count their launches on
``paged_flash_decode_bkhd.launches`` (the ``paged_decode`` entry of
``ops.launch_counts()``; never plain-version calls).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import tile_rows

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 8 + [_I] * 12 + [ctypes.c_float, _I, _C]
MAX_ROW_WIDTH = 4096       # rows * hd accumulators of a CUDA-core CTA
SPLITS = 8                 # CTAs per (b, kv-head) in the decode form
CHUNK_SPLITS = 4           # CTAs per (b, kv-head, row block), chunk form
TC_ROWS = 64               # query rows of a tensor-core CTA (csrc kWgRows)
MAX_SMEM_BYTES = 232_448   # dynamic shared memory of one H100 block
# head dim -> the tensor-core route's shared memory: a Q tile, K and V
# rings of two 64-position tiles, 1024 bytes of alignment (csrc
# wg_smem_bytes)
TC_SMEM_BYTES = {hd: 5 * TC_ROWS * 2 * hd + 1024 for hd in (64, 128, 256)}


def simt_smem_bytes(rows: int, hd: int, esize: int) -> int:
    """Dynamic shared memory of one CUDA-core CTA (csrc ``simt_smem_bytes``):
    the K ring (rows padded by 16 bytes) and the V ring, two tiles of
    ``flash_decode.tile_rows`` positions each (128 in bf16, 64 in fp32,
    halved above hd 128), then in fp32 the block's q, the tile's
    probabilities, (m, l, alpha) and the rows' lengths."""
    tr = tile_rows(hd, esize)
    return (esize * 2 * tr * (2 * hd + 16 // esize)
            + 4 * (rows * hd + rows * tr + 4 * rows))


def launch_plan(ck: int, G: int, hd: int, dtype: torch.dtype, chunk: bool
                ) -> Tuple[bool, int, int]:
    """(tensor_cores, query rows per CTA, splits) of one launch: the chunk
    form in bf16 at hd 64, 128 and 256 runs on ``wgmma`` in blocks of 64
    rows, ``CHUNK_SPLITS`` CTAs per block; every other launch on the CUDA
    cores, with as many rows as fit its accumulators (all G rows of a
    decode step)."""
    if chunk and dtype == torch.bfloat16 and hd in TC_SMEM_BYTES:
        return True, TC_ROWS, CHUNK_SPLITS
    return (False, min(ck * G, MAX_ROW_WIDTH // hd),
            CHUNK_SPLITS if chunk else SPLITS)


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


def paged_flash_decode_chunk_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   tables: torch.Tensor,
                                   lengths: torch.Tensor, *,
                                   softcap: float = 0.0) -> torch.Tensor:
    """q (B,ck,KV,G,hd); lengths (B,ck) -> like q: the single form's plain
    version per chunk token j at lengths[:, j], stacked (its definition)."""
    return torch.stack([paged_flash_decode_plain(
        q[:, j], k_pages, v_pages, tables, lengths[:, j], softcap=softcap)
        for j in range(q.shape[1])], dim=1)


def _launch_fn():
    """The kernel's C entry point, its argument types set once."""
    fn = build.load("paged_decode").paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, tables: torch.Tensor,
               lengths: torch.Tensor, chunk: bool
               ) -> Tuple[int, bool, int, int]:
    """Raise on what the kernel does not take, before any launch: q
    (B,ck,KV,G,hd) and lengths (B,ck) with ``chunk``, else q (B,KV,G,hd)
    and lengths (B,) (the same memory layout with ck = 1); pools
    (KV,P,ps,hd) of q's dtype; int32 tables (B, n_pages) with unit-stride
    columns and int32 lengths; everything on q's device; hd a multiple of
    8 and the block's shared memory within one H100 block
    (``TC_SMEM_BYTES`` on the tensor cores, ``simt_smem_bytes`` on the
    CUDA cores). Returns (ck, ``launch_plan``)."""
    dev, dt = q.device, q.dtype
    build.check_operand("q", q, dev, dt, 5 if chunk else 4)
    build.check_operand("k_pages", k_pages, dev, dt, 4)
    build.check_operand("v_pages", v_pages, dev, dt, 4)
    build.check_operand("lengths", lengths, dev, torch.int32,
                        2 if chunk else 1, aligned=False)
    if chunk:
        B, ck, KV, G, hd = q.shape
    else:
        (B, KV, G, hd), ck = q.shape, 1
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
            or tables.shape[0] != B or B == 0 \
            or lengths.shape != ((B, ck) if chunk else (B,)) \
            or ck == 0 or ps == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)} tables "
                         f"{tuple(tables.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    tc, rows, splits = launch_plan(ck, G, hd, dt, chunk)
    smem = (TC_SMEM_BYTES[hd] if tc
            else simt_smem_bytes(rows, hd, q.element_size()))
    if hd % 8 or rows < 1 or smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode needs hd % 8 == 0, hd <= "
                         f"{MAX_ROW_WIDTH} and {smem} bytes of shared memory "
                         f"<= {MAX_SMEM_BYTES}, got G={G} hd={hd}")
    return ck, tc, rows, splits


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            tables: torch.Tensor, lengths: torch.Tensor, softcap: float,
            chunk: bool) -> torch.Tensor:
    """Check the operands (``check_args``), launch, return out like q."""
    ck, tc, rows, splits = check_args(q, k_pages, v_pages, tables, lengths,
                                      chunk)
    dev = q.device
    B, KV, G, hd = q.shape[0], k_pages.shape[0], q.shape[-2], q.shape[-1]
    P, ps, n_pages = k_pages.shape[1], k_pages.shape[2], tables.shape[1]
    n_blocks = B * KV * -(-ck * G // rows)
    fn = _launch_fn()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, arrivals = build.workspace(
        dev, stream, n_blocks * splits * (rows * hd + 2 * rows), n_blocks)
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            partials.data_ptr(), arrivals.data_ptr(), B, ck, KV, G, P, ps,
            hd, n_pages, tables.stride(0), rows, splits, int(tc),
            float(softcap), build.dtype_code(q), stream)
    # The decode step calls this once per layer and is bound by host time:
    # switch devices only when the call needs it.
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    build.check_launch("paged_decode", err)
    paged_flash_decode_bkhd.launches += 1
    return out


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
    return _launch(q, k_pages, v_pages, tables, lengths, softcap,
                   chunk=False)


def paged_flash_decode_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor, *, softcap: float = 0.0
                             ) -> torch.Tensor:
    """q (B,ck,KV,G,hd); k/v_pages (KV,P,ps,hd); tables (B,n_pages) int32;
    lengths (B,ck) int32 -> like q: query token j of row b attends to the
    row's first ``min(lengths[b, j], n_pages·ps)`` positions, exactly as
    ``paged_flash_decode_bkhd(q[:, j], ..., lengths[:, j])`` would. Table
    entries as there, for the largest length of each row. In bf16 at hd
    64, 128 and 256 (tensor cores), positions between a query's length and
    the largest length of its block of 64 query rows must hold finite V:
    they enter the product with a zero weight (in the engine they are the
    chunk's own positions, written before the call, or earlier contents of
    the row's pages)."""
    if q.device.type == "cpu":
        return paged_flash_decode_chunk_plain(q, k_pages, v_pages, tables,
                                              lengths, softcap=softcap)
    return _launch(q, k_pages, v_pages, tables, lengths, softcap, chunk=True)


paged_flash_decode_bkhd.launches = 0

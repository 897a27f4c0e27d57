"""GQA decode attention over a dense KV cache: the CUDA kernels
``csrc/flash_decode.cu``, ``csrc/flash_decode_chunk.cu`` and
``csrc/flash_decode_step.cu`` (replacing the TPU kernel
``repro/kernels/flash_decode.py:flash_decode_bkhd``) and their plain
PyTorch version, in two forms:

- ``flash_decode_bkhd``: one query token per row (the decode step);
- ``flash_decode_chunk``: ``ck`` query tokens per row with a bias row each
  (the dense fused tick's prefill chunk), defined as the stack over j of the
  single form at ``bias[:, j]`` — the reference's per-token loop
  (``repro/models/attention.py:758-765``), in one launch.

Each is the wrapper of its form: CPU tensors take the plain version; CUDA
tensors launch a kernel or raise. ``launch_plan`` picks the kernel before
any launch (``KERNELS`` names it): the chunk form in bf16 at hd 64, 128
and 256 runs on the tensor cores (``flash_decode_chunk.cu``: ``wgmma`` over
blocks of 64 query rows), and so does the decode step in bf16 at hd 64,
128 and 256 with G <= 16 (``flash_decode_step.cu``: ``mma.sync`` with the
G query rows as its M, ``STEP_SPLITS[hd]`` CTAs per (b, kv-head) walking
tiles of ``STEP_TILE[hd]`` positions); every other launch (fp32, a group
above 16 rows) runs on the CUDA cores (``flash_decode.cu``).
A launch splits the cache axis over several CTAs per (b, kv-head, block of
query rows); each writes its partial softmax sums to a scratch workspace
and the last to arrive combines them, counted on a per-block arrival
counter that it leaves at zero. The workspace (partials and counters,
``build.workspace``) is allocated once per device and stream and shared
with paged_decode: launches on one stream run in order, so they never
share it while in flight. The tensor-core decode step needs none: a (b,
kv-head)'s splits are one thread block cluster and combine through its
distributed shared memory. ``flash_decode_bkhd.launches`` and
``flash_decode_chunk.launches`` count each form's kernel launches (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 7 + [_I] * 7 + [ctypes.c_float, _I, _C]
# flash_decode_step_launch: q, k, v, bias, out; B, KV, G, C, hd, splits,
# tile; softcap; dtype; stream
_STEP_ARGTYPES = [_C] * 5 + [_I] * 7 + [ctypes.c_float, _I, _C]
MAX_GROUP_WIDTH = 4096          # rows * hd accumulators per CTA (csrc kMaxAcc)
SPLITS = 8                      # CTAs per (b, kv-head, row block) (kSplits)
MAX_SMEM_BYTES = 232_448        # dynamic shared memory of one H100 block
TC_ROWS = 64                    # query rows of a tensor-core CTA (kRows)
TC_SPLITS = 4                   # its CTAs per (b, kv-head, row block)
# head dim -> the tensor-core route's shared memory: a Q tile, K and V
# rings of two 64-position tiles, 1024 bytes of alignment (csrc Shape)
TC_SMEM_BYTES = {hd: 5 * TC_ROWS * 2 * hd + 1024 for hd in (64, 128, 256)}
# The decode step's tensor-core route (bf16, hd 64, 128 and 256): query
# rows of the mma M (G <= 16 live), then by head dim the CTAs per (b,
# kv-head), one cluster of at most 8 (csrc kMaxSplits), and the positions
# of a K/V tile, from the instances the library has (``STEP_TILES``: 64,
# and 128 at hd 64). The counts and tiles are the fastest of chip_smoke
# --ab's sweeps (device ms on an H100): 6 at internvl2-26b's 64 (b,
# kv-head) pairs (384 CTAs, 96 positions each), 8 at gemma-2b's 8 (64
# CTAs, 72 positions each); at hd 64 6 splits of one 128-position tile
# (tinyllama's 96 positions a split in one round of copies: 0.0083, 0.0089
# in 64-position tiles; granite's G 3 0.0104-0.0108, level with 5 and 7)
STEP_ROWS = 16
STEP_SPLITS = {64: 6, 128: 6, 256: 8}
STEP_TILES = {64: (64, 128), 128: (64,), 256: (64,)}
STEP_TILE = {64: 128, 128: 64, 256: 64}


def step_smem_bytes(hd: int, tile: int) -> int:
    """Dynamic shared memory of one step CTA (csrc ``step::smem_bytes``):
    Q and a K and a V tile of ``tile`` positions in rows of hd + 8 bf16,
    then P (16 rows of tile + 4) and the four warps' row max and sum in
    fp32. The split's partial (16 rows of hd + 4 floats, m, l) goes where
    the K tile was."""
    return (2 * (STEP_ROWS + 2 * tile) * (hd + 8)
            + 4 * (STEP_ROWS * (tile + 4) + 2 * 4 * STEP_ROWS))


STEP_SMEM_BYTES = {hd: step_smem_bytes(hd, STEP_TILE[hd])
                   for hd in STEP_SPLITS}
# (tensor cores, chunk form) of a plan -> its library and CUDA kernel
KERNELS = {(True, True): ("flash_decode_chunk", "flash_decode_chunk_kernel"),
           (True, False): ("flash_decode_step", "flash_decode_step_kernel"),
           (False, True): ("flash_decode", "flash_decode_kernel"),
           (False, False): ("flash_decode", "flash_decode_kernel")}


def chunk_rows(ck: int, G: int, hd: int) -> int:
    """Query rows of one CTA: whole groups of G rows (a chunk token's G
    heads share its bias row), as many tokens as the accumulators hold
    (rows * hd <= ``MAX_GROUP_WIDTH``), at most all ck of them. The decode
    step (ck = 1) takes its G rows. Above the accumulators even one group
    (G * hd > 4096) gives G rows, which the wrapper refuses."""
    return G * max(1, min(ck, MAX_GROUP_WIDTH // (G * hd)))


def tile_rows(hd: int, esize: int) -> int:
    """Cache positions of one shared-memory tile (csrc ``tile_rows``): 128
    in bf16, 64 in fp32, halved above hd 128 so the ring does not grow with
    hd."""
    return (128 if esize == 2 else 64) // (2 if hd > 128 else 1)


def smem_bytes(G: int, hd: int, esize: int, rows: int = 0) -> int:
    """Dynamic shared memory of one CTA for a block of ``rows`` query rows
    (default G: the decode step) and elements of ``esize`` bytes (csrc
    ``smem_bytes``): the K ring (rows padded by 16 bytes) and the V ring,
    two tiles of ``tile_rows`` positions each, then in fp32 the biases of
    both tiles for each of the block's rows / G chunk tokens, q, the tile's
    probabilities and (m, l, alpha)."""
    rows = rows or G
    tr = tile_rows(hd, esize)
    return (esize * 2 * tr * (2 * hd + 16 // esize)
            + 4 * (2 * (rows // G) * tr + rows * hd + rows * tr + 3 * rows))


def launch_plan(ck: int, G: int, hd: int, dtype: torch.dtype, chunk: bool
                ) -> Tuple[bool, int, int]:
    """(tensor_cores, query rows per CTA, splits) of one launch: the chunk
    form in bf16 at hd 64, 128 and 256 runs on ``wgmma`` in blocks of 64
    query rows (``flash_decode_chunk.cu``), whatever ck and G, with
    ``TC_SPLITS`` CTAs per block; the decode step in bf16 at hd 64, 128
    and 256 with G <= 16 on ``mma.sync`` with its G rows in a 16-row M
    (``flash_decode_step.cu``), ``STEP_SPLITS[hd]`` CTAs per (b,
    kv-head); every other launch (a decode step above 16 rows or of one
    row at hd 64, fp32) on the CUDA cores (``flash_decode.cu``), with
    whole groups of G rows as the accumulators hold (``chunk_rows``).
    ``KERNELS[tc, chunk]`` names the kernel."""
    if dtype == torch.bfloat16:
        if chunk and hd in TC_SMEM_BYTES:
            return True, TC_ROWS, TC_SPLITS
        # At hd 64 one query row (whisper-tiny's G 1) keeps the CUDA-core
        # kernel: one live row of the step kernel's 16 took 0.0093 ms at
        # best (tile 128, 5 splits) against that kernel's 0.0092-0.0093 at
        # whisper-tiny's serve shape (chip_smoke --ab), no faster.
        if (not chunk and hd in STEP_SPLITS and G <= STEP_ROWS
                and (G > 1 or hd > 64)):
            return True, STEP_ROWS, STEP_SPLITS[hd]
    return False, chunk_rows(ck, G, hd) if chunk else G, SPLITS


_FNS = {}                       # (tc, chunk) -> its C entry point


def _launch_fn(tc: bool, chunk: bool):
    """The C entry point of the planned kernel (``KERNELS``), its argument
    types set once (the chunk kernels take the same arguments; the step
    kernel its own)."""
    fn = _FNS.get((tc, chunk))
    if fn is None:
        name = KERNELS[tc, chunk][0]
        fn = _FNS[tc, chunk] = getattr(build.load(name), f"{name}_launch")
        fn.argtypes = (_STEP_ARGTYPES if tc and not chunk else _ARGTYPES)
        fn.restype = ctypes.c_int
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


def flash_decode_chunk_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor, *,
                             softcap: float = 0.0) -> torch.Tensor:
    """q (B,ck,KV,G,hd); k, v (B,KV,C,hd); bias (B,ck,C) -> like q: the
    single form's plain version per chunk token j at bias[:, j], stacked
    (its definition)."""
    return torch.stack([flash_decode_plain(q[:, j], k, v, bias[:, j],
                                           softcap=softcap)
                        for j in range(q.shape[1])], dim=1)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, chunk: bool
               ) -> Tuple[int, bool, int, int]:
    """Raise on what neither kernel takes, before any launch: q
    (B,ck,KV,G,hd) and bias (B,ck,C) with ``chunk``, else q (B,KV,G,hd)
    and bias (B,C); k, v (B,KV,C,hd) of q's dtype; every operand
    contiguous, 16-byte aligned and on q's device, the bias fp32; the
    block's shared memory within one H100 block (``TC_SMEM_BYTES`` for the
    chunk form and ``step_smem_bytes`` for the decode step on the tensor
    cores, ``smem_bytes`` on the CUDA cores); on the CUDA cores also
    hd a multiple of 8 and a group of G rows within the accumulators (the
    tensor-core route takes bf16 at hd 64, 128 and 256 at any G). Returns
    (ck, ``launch_plan``)."""
    dev, dt = q.device, q.dtype
    for name, t, tdt, nd in (("q", q, dt, 5 if chunk else 4),
                             ("k", k, dt, 4), ("v", v, dt, 4),
                             ("bias", bias, torch.float32,
                              3 if chunk else 2)):
        build.check_operand(name, t, dev, tdt, nd)
    if chunk:
        B, ck, KV, G, hd = q.shape
    else:
        (B, KV, G, hd), ck = q.shape, 1
    C = k.shape[2]
    if k.shape != (B, KV, C, hd) or v.shape != k.shape or C == 0 \
            or ck == 0 or bias.shape != ((B, ck, C) if chunk else (B, C)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(bias.shape)}")
    tc, rows, splits = launch_plan(ck, G, hd, dt, chunk)
    smem = ((TC_SMEM_BYTES[hd] if chunk
             else step_smem_bytes(hd, STEP_TILE[hd])) if tc
            else smem_bytes(G, hd, q.element_size(), rows))
    if smem > MAX_SMEM_BYTES or not tc and (hd % 8
                                            or rows * hd > MAX_GROUP_WIDTH):
        raise ValueError(f"flash_decode needs hd % 8 == 0, G*hd <= "
                         f"{MAX_GROUP_WIDTH} and {smem} bytes of shared "
                         f"memory <= {MAX_SMEM_BYTES}, got G={G} hd={hd}")
    return ck, tc, rows, splits


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, softcap: float, chunk: bool) -> torch.Tensor:
    """Check the operands (``check_args``), launch the planned kernel,
    return out like q."""
    ck, tc, rows, splits = check_args(q, k, v, bias, chunk)
    dev = q.device
    B, KV, C = k.shape[0], k.shape[1], k.shape[2]
    G, hd = q.shape[-2], q.shape[-1]
    # the step kernel's splits combine in their cluster: no workspace (it
    # is still set up for the stream, empty, as every launch leaves it)
    n_blocks = 0 if tc and not chunk else B * KV * -(-ck * G // rows)
    fn = _launch_fn(tc, chunk)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, arrivals = build.workspace(
        dev, stream, n_blocks * splits * (rows * hd + 2 * rows), n_blocks)
    if tc and not chunk:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, KV, G, C, hd, splits, STEP_TILE[hd],
                float(softcap), build.dtype_code(q), stream)
    else:
        # the tensor-core chunk kernel takes its split count where the
        # CUDA-core one takes its rows per CTA (their rows and its 8 splits
        # are constants)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(), B,
                KV, G, C, hd, ck, splits if tc else rows, float(softcap),
                build.dtype_code(q), stream)
    # The decode step calls this once per layer and is bound by host time:
    # switch devices only when the call needs it.
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    build.check_launch(KERNELS[tc, chunk][0], err)
    return out


def flash_decode_bkhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, *, softcap: float = 0.0
                      ) -> torch.Tensor:
    """q (B,KV,G,hd); k, v (B,KV,C,hd); bias (B,C) float32 -> like q.
    Any C: the kernel masks the ragged tail itself (nothing is padded)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias, softcap=softcap)
    out = _launch(q, k, v, bias, softcap, chunk=False)
    flash_decode_bkhd.launches += 1
    return out


def flash_decode_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, *, softcap: float = 0.0
                       ) -> torch.Tensor:
    """q (B,ck,KV,G,hd); k, v (B,KV,C,hd); bias (B,ck,C) float32 -> like
    q: query token j of row b attends under the bias row (b, j), exactly as
    ``flash_decode_bkhd(q[:, j], k, v, bias[:, j])`` would, in one launch
    (in bf16 at hd 64, 128 and 256 on the tensor cores, whose sum order
    differs from the single form's; elsewhere the same arithmetic in the
    same order).
    Preconditions: every position of a query row whose bias is -1e9 still
    enters its sums with a zero weight, so the cache must be finite there
    (in the engine it holds stale but finite entries); rows are
    independent, so a padded query or an inert row cannot reach a live
    one; any C >= 1, also below the split count (a split without positions
    adds nothing)."""
    if q.device.type == "cpu":
        return flash_decode_chunk_plain(q, k, v, bias, softcap=softcap)
    out = _launch(q, k, v, bias, softcap, chunk=True)
    flash_decode_chunk.launches += 1
    return out


flash_decode_bkhd.launches = 0
flash_decode_chunk.launches = 0

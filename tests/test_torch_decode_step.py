"""The decode step's tensor-core routes on the CPU: both wrappers' launch
plans and checks at every (hd, dtype, G) edge, the step kernel's shared
memory, a mirror of the paged step's split bounds, and the paged plain
version at the row lengths those bounds split, against the reference.

The bf16 decode step at hd 64, 128 and 256 with G <= 16 runs the step
kernel (``csrc/decode_step.cuh``: the G query rows as the 16-row M of
``mma.sync``, a (b, kv-head)'s splits one thread block cluster), dense
(``csrc/flash_decode_step.cu``) and paged (``csrc/paged_decode_step.cu``);
fp32 and a group above 16 rows keep the CUDA-core kernels. The kernels run
only on the card (``tests/test_torch_cuda.py``, chip_smoke); here the plans
are CPU functions and the wrappers take their plain versions. The paged
plain version is held to the reference's Pallas ``paged_flash_decode_bkhd``
(interpret mode) and its oracle ``ref_paged_decode``: fp32 1e-5 absolute
(sums in other orders), bf16 3e-2 (each side rounds an fp32 result to
bf16), as in tests/test_torch_paged.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import to_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import paged_decode as pd

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
BF = torch.bfloat16


def _dense_args(G, hd, dtype, device="cpu"):
    q = torch.zeros((2, 3, G, hd), dtype=dtype, device=device)
    k = torch.zeros((2, 3, 40, hd), dtype=dtype, device=device)
    return q, k, k, torch.zeros((2, 40), device=device)


def _paged_args(G, hd, dtype, device="cpu"):
    q = torch.zeros((2, 3, G, hd), dtype=dtype, device=device)
    pool = torch.zeros((3, 9, 8, hd), dtype=dtype, device=device)
    return (q, pool, pool,
            torch.zeros((2, 4), dtype=torch.int32, device=device),
            torch.ones(2, dtype=torch.int32, device=device))


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 3, 8, 16, 17])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("form", ["dense", "paged"])
def test_decode_step_plan_at_every_edge(form, hd, G, dtype):
    """The bf16 decode step at hd 64, 128 and 256 with G up to the step
    kernel's 16 rows plans the step kernel (``STEP_ROWS`` rows,
    ``STEP_SPLITS[hd]`` CTAs per (b, kv-head), at most a cluster's 8),
    except the dense step of one row at hd 64 (whisper-tiny's G 1, no
    faster there); fp32 and G 17 plan the CUDA-core kernel with their G
    rows (as many as 4096 accumulators hold) and ``SPLITS``.
    ``check_args`` returns that plan, except where the CUDA-core block
    cannot hold G 17 rows of hd 256: the dense kernel refuses it before any
    launch, the paged one takes two row blocks of 16."""
    mod = fd if form == "dense" else pd
    tc = dtype == BF and G <= 16 and not (form == "dense" and hd == 64
                                          and G == 1)
    rows = 16 if tc else G if form == "dense" else min(G, 4096 // hd)
    splits = mod.STEP_SPLITS[hd] if tc else mod.SPLITS
    assert mod.launch_plan(1, G, hd, dtype, False) == (tc, rows, splits)
    assert mod.STEP_ROWS == 16 and 1 <= mod.STEP_SPLITS[hd] <= 8
    assert mod.KERNELS[tc, False] == (
        {"dense": ("flash_decode_step", "flash_decode_step_kernel"),
         "paged": ("paged_decode_step", "paged_decode_step_kernel")}[form]
        if tc else {"dense": ("flash_decode", "flash_decode_kernel"),
                    "paged": ("paged_decode", "paged_decode_simt_kernel")
                    }[form])
    args = (_dense_args if form == "dense" else _paged_args)(G, hd, dtype)
    if form == "dense" and G * hd > fd.MAX_GROUP_WIDTH:
        with pytest.raises(ValueError, match="G\\*hd"):
            fd.check_args(*args, False)
        return
    assert mod.check_args(*args, False) == (1, tc, rows, splits)
    # the chunk forms keep their plans
    assert mod.launch_plan(16, G, hd, dtype, True)[0] == (dtype == BF)


@pytest.mark.parametrize("hd,tile,smem", [(64, 64, 25_600),
                                          (64, 128, 48_128),
                                          (128, 64, 44_032),
                                          (256, 64, 80_896)])
def test_step_shared_memory(hd, tile, smem):
    """One step CTA's shared memory at each instance the libraries build
    (``STEP_TILES``): Q, a K and a V tile of ``tile`` positions in rows of
    hd + 8 bf16, P (16 rows of tile + 4) and the four warps' row max and
    sum in fp32; several CTAs an SM; the split's partial for the cluster
    combine (16 rows of hd + 4 floats, m and l) fits where the K tile
    was. Both wrappers plan the tile ``STEP_TILE[hd]``, an instance."""
    assert tile in fd.STEP_TILES[hd]
    assert fd.step_smem_bytes(hd, tile) == smem == (
        2 * (16 + 2 * tile) * (hd + 8) + 4 * (16 * (tile + 4) + 128))
    assert fd.MAX_SMEM_BYTES // smem >= 2
    assert 4 * (16 * (hd + 4) + 2 * 16) <= 2 * tile * (hd + 8)
    for mod in (fd, pd):
        assert mod.STEP_TILE[hd] in fd.STEP_TILES[hd]
        assert mod.STEP_SMEM_BYTES[hd] == fd.step_smem_bytes(
            hd, mod.STEP_TILE[hd])


@pytest.mark.parametrize("form", ["dense", "paged"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_wrapper_loads_the_step_library_after_the_checks(monkeypatch, form,
                                                         hd):
    """On a non-CPU tensor (here meta) the bf16 decode step checks its
    operands, then loads the step kernel's library: a refused operand
    raises before any library is loaded; nothing falls back to the plain
    version or to the CUDA-core kernel, and no launch is counted."""
    mod = fd if form == "dense" else pd
    wrap = fd.flash_decode_bkhd if form == "dense" \
        else pd.paged_flash_decode_bkhd
    asked = []

    def load(name):
        asked.append(name)
        raise RuntimeError("no kernels here")

    monkeypatch.setattr(mod.build, "load", load)
    args = list((_dense_args if form == "dense" else _paged_args)(
        8, hd, BF, "meta"))
    bad = list(args)
    bad[-1] = bad[-1].to(torch.float64 if form == "dense" else torch.int64)
    n0 = wrap.launches
    with pytest.raises(TypeError):
        wrap(*bad)
    assert asked == []
    with pytest.raises(RuntimeError, match="no kernels here"):
        wrap(*args)
    assert asked == [mod.KERNELS[True, False][0]] and wrap.launches == n0


# ------------------------------------------------ the paged split bounds
def step_split_bounds(length, n_pages, ps, splits):
    """The step kernel's split of one row's positions, as
    ``csrc/decode_step.cuh``'s ``split_range`` computes it: [(c0, n)] for
    each split, from the row's live length L = min(max(length, 0),
    n_pages * ps) alone (never a page id), ceil(L / splits) positions a
    split, contiguous, the last ones short or empty."""
    live = max(0, min(length, n_pages * ps))
    chunk = -(-live // splits)
    out = []
    for s in range(splits):
        c0 = min(live, s * chunk)
        out.append((c0, min(live, c0 + chunk) - c0))
    return out


def _reads(table, length, n_pages, ps, splits, tile):
    """What the paged step kernel reads of one row, as its loops run: for
    each split (``step_split_bounds``) its tiles of ``tile`` positions,
    and in each the table entry of every position below the split's end
    (positions past it are zero-filled, never resolved). Returns (split
    bounds, [(position, table column, page id)])."""
    bounds = step_split_bounds(length, n_pages, ps, splits)
    reads = []
    for c0, n in bounds:
        for j0 in range(0, n, tile):
            for r in range(min(tile, n - j0)):
                t = c0 + j0 + r
                reads.append((t, t // ps, int(table[t // ps])))
    return bounds, reads


@settings(max_examples=300, deadline=None)
@given(length=st.integers(-3, 700), n_pages=st.integers(0, 40),
       ps=st.integers(1, 32), splits=st.integers(1, 8),
       tile=st.sampled_from([64, 128]), seed=st.integers(0, 2**16))
def test_paged_split_bounds_cover_each_live_position_once(
        length, n_pages, ps, splits, tile, seed):
    """The paged step's splits cover each live position (t < L = min(max(
    length, 0), n_pages * ps)) exactly once, in order, and nothing past L;
    no table entry at or past column ceil(L / ps) is read (there an
    out-of-range entry sits, -1); the bounds depend on the length alone:
    another table gives the same bounds and the same positions, each read
    through its own table's entry."""
    rng = np.random.default_rng(seed)
    live = max(0, min(length, n_pages * ps))
    width = n_pages + 2
    table = rng.integers(0, 1000, width)
    table[-(-live // ps):] = -1
    bounds, reads = _reads(table, length, n_pages, ps, splits, tile)
    assert len(bounds) == splits
    assert [t for t, _, _ in reads] == list(range(live))
    at = 0
    for c0, n in bounds:
        assert n >= 0 and (c0 == at or n == 0) and c0 + n <= live
        at += n
    assert at == live
    assert all(page >= 0 and col < -(-live // ps) for _, col, page in reads)
    other = rng.integers(0, 1000, width)
    other[-(-live // ps):] = -1
    bounds2, reads2 = _reads(other, length, n_pages, ps, splits, tile)
    assert bounds2 == bounds
    assert [(t, c) for t, c, _ in reads2] == [(t, c) for t, c, _ in reads]
    assert all(p == other[c] for _, c, p in reads2)


@pytest.mark.parametrize("length,n_pages,ps,splits,want", [
    (0, 36, 16, 8, [(0, 0)] * 8),
    (3, 36, 16, 8, [(0, 1), (1, 1), (2, 1)] + [(3, 0)] * 5),
    (576, 36, 16, 8, [(72 * s, 72) for s in range(8)]),
    (203, 36, 16, 6, [(0, 34), (34, 34), (68, 34), (102, 34), (136, 34),
                      (170, 33)]),
    (1000, 36, 16, 6, [(96 * s, 96) for s in range(6)]),  # capped at 576
    (-4, 36, 16, 4, [(0, 0)] * 4),
])
def test_paged_split_bounds_at_the_serve_shapes(length, n_pages, ps, splits,
                                                want):
    """The split bounds the kernel takes at the serve path's 36 pages of
    16: empty splits at a length of 0 or below the split count, 72
    positions a split at a full row over 8 splits, a length capped at
    n_pages * ps, a negative length counted as 0."""
    assert step_split_bounds(length, n_pages, ps, splits) == want


# ------------------------------------- the paged plain version at the edges
PS, WIDTH = 8, 3


def _edge_np(rng, KV, G, hd):
    """q, pools and tables of six rows whose lengths are 0, 1, ps - 1, ps,
    ps + 1 and n_pages * ps (the step route's edges)."""
    B = 6
    P = B * WIDTH + 1
    tables = rng.permutation(np.arange(1, P)).reshape(B, WIDTH)
    lengths = np.array([0, 1, PS - 1, PS, PS + 1, WIDTH * PS])
    return (rng.standard_normal((B, KV, G, hd), dtype=np.float32),
            rng.standard_normal((KV, P, PS, hd), dtype=np.float32),
            rng.standard_normal((KV, P, PS, hd), dtype=np.float32),
            tables.astype(np.int32), lengths.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("KV,G,hd,softcap", [
    (4, 8, 64, 0.0),            # tinyllama-1.1b's heads
    (8, 3, 64, 30.0),           # granite-moe's G 3, softcap
    (2, 1, 64, 0.0),            # G 1 (whisper-tiny's group)
    (2, 6, 128, 0.0),           # internvl2-26b's G 6
    (1, 16, 128, 0.0),          # the whole 16-row M
    (1, 8, 256, 30.0),          # gemma-2b's hd 256, softcap
])
def test_plain_paged_step_at_the_length_edges(KV, G, hd, softcap, dtype):
    """What the wrapper computes on CPU tensors at the step route's heads
    and length edges equals the reference's Pallas kernel and oracle; the
    length-0 row gives zeros; a length above n_pages * ps gives the same
    as n_pages * ps."""
    q, kp, vp, tables, lengths = _edge_np(np.random.default_rng(hd + G), KV,
                                          G, hd)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, kp, vp))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, kp, vp))
    tt, tl = torch.as_tensor(tables), torch.as_tensor(lengths)
    got = pd.paged_flash_decode_bkhd(tq, tk, tv, tt, tl, softcap=softcap)
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    for want in (jops.paged_flash_decode(jq, jk, jv, jt, jl,
                                         softcap=softcap),
                 jref.ref_paged_decode(jq, jk, jv, jt, jl, softcap=softcap)):
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dtype])
    assert not to_np(got)[0].any()                  # length 0 -> zeros
    above = pd.paged_flash_decode_bkhd(
        tq, tk, tv, tt, torch.where(tl == WIDTH * PS, WIDTH * PS + 5, tl),
        softcap=softcap)
    assert torch.equal(above, got)

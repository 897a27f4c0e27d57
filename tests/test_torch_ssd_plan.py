"""The SSD scan wrapper's launch plan and its refusals, on the CPU.

``kernels/ssd_scan.py`` computes, in plain Python, the three launches of
one CUDA call (chunk states and C.B, the state pass, the outputs): their
grids, threads and shared memory, and the per-stream workspace they share.
These tests hold that plan for every (p, n) the kernel is built for and
every chunk from 1 to 128, and the refusals that ``check_args`` decides
before any launch, on CPU and meta tensors (the kernel itself runs only on
the card: tests/test_torch_cuda.py).
"""
import itertools

import pytest
import torch

import _torch_parity  # noqa: F401  (thread limit)
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

DTYPES = ("torch.bfloat16", "torch.float32")


@pytest.mark.parametrize("p,n", list(itertools.product(ss.HEAD_DIMS,
                                                       ss.STATE_DIMS)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_every_chunk(p, n, dtype):
    """Every launch of every chunk fits one H100 block's shared memory; in
    bf16 (the serve path) at least two CTAs of each launch fit on an SM."""
    for chunk in range(1, ss.MAX_CHUNK + 1):
        plan = ss.launch_plan(3, 300, 5, p, n, chunk, dtype)
        nc = -(-300 // chunk)
        qp = -(-chunk // 16) * 16
        chunk_l, pass_l, out_l = plan["launches"]
        assert [k["kernel"] for k in plan["launches"]] == [
            "ssd_scan_chunk", "ssd_scan_pass", "ssd_scan_out"]
        assert chunk_l["grid"] == (6, nc, 3) and out_l["grid"] == (5, nc, 3)
        assert pass_l["grid"] == (-(-p * n // 4 // ss.THREADS), 5, 3)
        assert pass_l["grid"][0] * ss.THREADS * 4 >= p * n
        for k in plan["launches"]:
            assert k["smem"] <= ss.MAX_SMEM_BYTES, (chunk, k)
            if dtype == "torch.bfloat16":
                assert 2 * k["smem"] <= ss.MAX_SMEM_BYTES, (chunk, k)
        assert plan["workspace_floats"] == 3 * nc * (5 * p * n + qp * qp + 5)


def test_plan_at_the_serve_shapes():
    """mamba2-130m (b=8, s=512, h=24, p=64, n=128, q=128) and hymba-1.5b
    (h=50, n=16): 800 / 1536 / 768 and 1632 / 400 / 1600 CTAs."""
    plan = ss.launch_plan(8, 512, 24, 64, 128, 128, "torch.bfloat16")
    assert [k["grid"] for k in plan["launches"]] == [
        (25, 4, 8), (8, 24, 8), (24, 4, 8)]
    assert [k["threads"] for k in plan["launches"]] == [256, 256, 256]
    # chunk states 25 MB, C.B 2 MB, decays 3 KB
    assert plan["workspace_floats"] == 8 * 4 * (24 * 64 * 128 + 128 * 128
                                                + 24)
    plan = ss.launch_plan(8, 512, 50, 64, 16, 128, "torch.bfloat16")
    assert [k["grid"] for k in plan["launches"]] == [
        (51, 4, 8), (1, 50, 8), (50, 4, 8)]


def _inputs(dtype=torch.bfloat16, b=2, s=40, h=3, p=64, n=16, device="cpu"):
    """x, B, C as views of one packed (b, s, h*p + 2n) tensor, as the model
    passes them; dt, A and the state packed."""
    xc = torch.zeros((b, s, h * p + 2 * n), dtype=dtype, device=device)
    x = xc[..., :h * p].unflatten(-1, (h, p))
    B, C = xc[..., h * p:h * p + n], xc[..., h * p + n:]
    dt = torch.zeros((b, s, h), device=device)
    A = torch.zeros(h, device=device)
    init = torch.zeros((b, h, p, n), device=device)
    return x, dt, A, B, C, init


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_check_args_takes_the_model_views(device):
    x, dt, A, B, C, init = _inputs(device=device)
    args = ss.check_args(x, dt, A, B, C, init, 16)
    w = 3 * 64 + 2 * 16
    assert args["shape"] == (2, 40, 3, 64, 16)
    assert args["strides"] == (40 * w, w, 40 * w, w)
    assert args["plan"] == ss.launch_plan(2, 40, 3, 64, 16, 16,
                                          "torch.bfloat16")


def _misaligned_x():
    """x one bf16 element past a 16-byte boundary (base and row stride)."""
    xc = torch.zeros((2, 40, 3 * 64 + 2 * 16 + 1), dtype=torch.bfloat16)
    return xc[..., 1:1 + 3 * 64].unflatten(-1, (3, 64))


REFUSALS = {
    # name: (make the arguments from the valid ones, exception)
    "x not 16-byte aligned": (
        lambda a: (_misaligned_x(), *a[1:]), ValueError),
    "B and C not 16-byte aligned": (
        lambda a: (*a[:3], *(torch.zeros((2, 40, 2 * 16 + 1),
                                         dtype=torch.bfloat16)[..., o:o + 16]
                             for o in (1, 17)), a[5], a[6]), ValueError),
    "x not packed in a row": (
        lambda a: (a[0].transpose(2, 3).contiguous().transpose(2, 3),
                   *a[1:]), ValueError),
    "p not built": (lambda a: (a[0][..., :48], *a[1:]), ValueError),
    "n not built": (
        lambda a: (*a[:3], a[3][..., :12], a[4][..., :12], *a[5:]),
        ValueError),
    "B in another dtype": (
        lambda a: (*a[:3], a[3].float(), *a[4:]), TypeError),
    "B and C strides differ": (
        lambda a: (*a[:4], a[4].contiguous(), *a[5:]), ValueError),
    "dt not fp32": (lambda a: (a[0], a[1].half(), *a[2:]), TypeError),
    "state of another shape": (
        lambda a: (*a[:5], a[5][:, :2].contiguous(), a[6]), ValueError),
    "state not 16-byte aligned": (
        lambda a: (*a[:5], torch.zeros(2 * 3 * 64 * 16 + 1)[1:].view(
            2, 3, 64, 16), a[6]), ValueError),
    "chunk 0": (lambda a: (*a[:6], 0), ValueError),
    "chunk above 128": (lambda a: (*a[:6], 129), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_args_refuses(case):
    make, exc = REFUSALS[case]
    valid = (*_inputs(), 16)
    ss.check_args(*valid)                        # the valid call passes
    with pytest.raises(exc):
        ss.check_args(*make(valid))


def test_cpu_wrapper_is_the_plain_version_and_never_counts():
    """On the CPU the wrapper takes the plain version, even for arguments
    the kernel would refuse (here a misaligned x), and counts nothing."""
    g = torch.Generator().manual_seed(0)
    x, dt, A, B, C, init = _inputs(dtype=torch.float32)
    xm = torch.randn((2, 40, 3 * 64 + 1), generator=g)[..., 1:].unflatten(
        -1, (3, 64))
    dt = torch.nn.functional.softplus(torch.randn(dt.shape, generator=g))
    A = -torch.rand(A.shape, generator=g)
    B = torch.randn(B.shape, generator=g)
    C = torch.randn(C.shape, generator=g)
    n0 = ss.ssd_scan_chunked.launches
    y, fin = ops.ssd_scan(xm, dt, A, B, C, chunk=16, initial_state=init)
    wy, wfin = ss.ssd_scan_plain(xm, dt, A, B, C, 16, init)
    assert ss.ssd_scan_chunked.launches == n0
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(fin, wfin, rtol=0, atol=0)

"""Each kernel's operations and bytes against a count by hand at one
shape, and a share that cannot pass its bound."""
import importlib.util
from pathlib import Path

import pytest

from perfbench.frozen.bound import bound_s
from perfbench.metrics._util import roofline_share

ROOF = Path(__file__).resolve().parents[1] / "roofline"
GRANITE = {"num_heads": 24, "num_kv_heads": 8, "head_dim": 64}
GEO = {"max_batch": 2, "prompt_len": 4, "max_new": 2}


def _mod(name):
    spec = importlib.util.spec_from_file_location(name, ROOF / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_flash_prefill_counts_by_hand():
    flops, nbytes = _mod("flash_prefill").counts(GRANITE, GEO)
    # 2 rows x 24 heads; causal over 4 positions: 1 + 2 + 3 + 4 = 10 pairs,
    # each 64-long dot product (QK^T) and 64-wide axpy (PV), 2 FLOPs each
    assert flops == 2 * 24 * 10 * 64 * 2 * 2
    # q and out: 2 x 4 x 24 x 64 bf16 each; k and v: 2 x 4 x 8 x 64 each
    assert nbytes == (2 * 4 * 24 * 64 * 2) * 2 + (2 * 4 * 8 * 64 * 2) * 2


def test_decode_step_counts_by_hand():
    flops, nbytes = _mod("decode_step").counts(GRANITE, GEO)
    C = 6                                  # prompt_len + max_new
    # 2 rows x 24 query heads, each over 6 positions of 64
    assert flops == 2 * 24 * C * 64 * 2 * 2
    # q, out: 2 x 24 x 64 bf16; the ring's k, v: 2 x 8 x 6 x 64 bf16; the
    # bias: 2 x 6 float32
    assert nbytes == 2 * (2 * 24 * 64 * 2) + 2 * (2 * 8 * C * 64 * 2) \
        + 2 * C * 4


def test_bound_takes_the_larger_of_bytes_and_operations():
    t, which = bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and which == "bytes"
    t, which = bound_s(1.0, 2 * 989e12)
    assert t == pytest.approx(2.0) and which == "operations"


class _Run:
    model = GRANITE
    geometry = GEO

    def __init__(self, kernels):
        self.kernels = kernels


def test_roofline_share_is_launches_times_bound_over_device_time():
    flops, nbytes = _mod("flash_prefill").counts(GRANITE, GEO)
    t, _ = bound_s(nbytes, flops)
    us = t * 1e6
    run = _Run([("void flash_prefill_wide_kernel<64, 1>", 0.0, 2 * us),
                ("void flash_prefill_wide_kernel<64, 1>", 5.0, 5.0 + 2 * us),
                ("nvjet_other", 0.0, 100.0)])
    assert roofline_share(run, "flash_prefill") == pytest.approx(50.0)
    assert roofline_share(_Run([("nvjet", 0.0, 1.0)]),
                          "flash_prefill") is None
    assert roofline_share(_Run(None), "decode_step") is None

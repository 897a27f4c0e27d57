"""The roofline bound of one kernel call.

Copied from ``chip_smoke.py`` ``bound()`` (commit 90524296), with the
H100 SXM rates of ``src/repro_torch/core/profiles.py`` (``HBM_BW``,
``PEAK_FLOPS_BF16``) written in: the least time the card could take is the
larger of bytes over the HBM bandwidth and operations over the dense bf16
peak (NVIDIA's data sheet, 700 W).
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, which bound holds: "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS_BF16
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")

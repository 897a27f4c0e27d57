"""Roofline-backed profiles for configs the CPU engine cannot run,
cross-calibrated against measured smoke-scale variants.

The offline profiler (``measure.EngineProfiler``) can only sweep variants
small enough to execute in-process; the TPU-scale ladder (e.g. a 6B model
on 1–64 chips) must come from the analytic roofline
(``repro_torch.core.profiles.roofline_profile``). Analytic rooflines are
systematically optimistic — they ignore dispatch overhead, host
orchestration, and kernel inefficiency. This module closes that gap the
INFaaS way: run the *same* analytic model over the smoke-scale variants we
DID measure, compare predicted vs measured throughput slopes, and carry the
resulting correction factor onto the unrunnable configs.

The factor is a geometric mean of per-variant measured/analytic slope
ratios (geometric so a single outlier variant cannot dominate), applied as
  th'(n)   = scale · th(n)
  p'(n)    = base + k/scale / n        (latency moves inversely)
On real TPU hardware the measured points come from the TPU engine and the
factor converges toward 1; on the CPU smoke rig it mostly captures
software overhead — either way it is *measured*, not assumed.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiles import VariantProfile, roofline_profile

from repro_torch.profiling.measure import ProfileMeasurement


def roofline_scale_factor(measurements: Mapping[str, ProfileMeasurement],
                          cfgs: Mapping[str, ModelConfig], *,
                          tokens_per_request: int = 128) -> float:
    """Cross-calibration factor: geometric mean over reference variants of
    (measured throughput slope) / (analytic roofline slope)."""
    ratios = []
    for name, m in measurements.items():
        cfg = cfgs.get(name)
        if cfg is None:
            continue
        analytic = roofline_profile(cfg, accuracy=m.profile.accuracy,
                                    tokens_per_request=tokens_per_request)
        a_slope = max(analytic.th_slope, 1e-12)
        m_slope = max(m.th_fit.slope, 1e-12)
        ratios.append(m_slope / a_slope)
    if not ratios:
        return 1.0
    return float(np.exp(np.mean(np.log(ratios))))


def calibrated_roofline_profile(cfg: ModelConfig, accuracy: float, *,
                                scale: float = 1.0,
                                tokens_per_request: int = 128,
                                max_chips: int = 64) -> VariantProfile:
    """Analytic profile for an unrunnable config, throughput scaled by the
    measured correction factor (latency scaled inversely)."""
    p = roofline_profile(cfg, accuracy, tokens_per_request=tokens_per_request,
                         max_chips=max_chips)
    s = max(scale, 1e-12)
    return VariantProfile(
        name=p.name, accuracy=p.accuracy, rt=p.rt,
        th_slope=p.th_slope * s, th_intercept=p.th_intercept * s,
        lat_base_ms=p.lat_base_ms, lat_k_ms=p.lat_k_ms / s,
        max_units=p.max_units)


def profile_unrunnable(cfgs: Sequence[ModelConfig],
                       accuracies: Sequence[float],
                       measurements: Mapping[str, ProfileMeasurement],
                       reference_cfgs: Mapping[str, ModelConfig], *,
                       tokens_per_request: int = 128, max_chips: int = 64,
                       store=None) -> Dict[str, VariantProfile]:
    """Profile TPU-scale configs via the cross-calibrated roofline; register
    into ``store`` under provenance ``"roofline"`` with the factor recorded."""
    scale = roofline_scale_factor(measurements, reference_cfgs,
                                  tokens_per_request=tokens_per_request)
    out: Dict[str, VariantProfile] = {}
    for cfg, acc in zip(cfgs, accuracies):
        p = calibrated_roofline_profile(
            cfg, acc, scale=scale, tokens_per_request=tokens_per_request,
            max_chips=max_chips)
        out[p.name] = p
        if store is not None:
            store.register(p, "roofline",
                           meta={"calibration_scale": scale,
                                 "references": sorted(measurements)})
    return out

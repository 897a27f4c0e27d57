"""Variant profiles: throughput/latency models per (variant, resource units).

Faithful to the paper's profiling methodology (§5): each variant is profiled
at a handful of allocations (1, 2, 4, 8, 16 cores) and a *linear regression*
``th_m(n) = a·n + b`` predicts throughput at any allocation; processing
latency is modeled as ``p_m(n) = base + k / n``.

Three profile sources, distinguished by *provenance* in the profile store
(``repro_torch.profiling.store.ProfileStore``):
  * ``paper-calibrated`` — ``paper_resnet_profiles()``: the paper's
    ResNet-18/34/50/101/152 family, calibrated so every relation the paper
    reports holds (Fig. 1/2).
  * ``roofline`` — ``roofline_profile(cfg, ...)``: throughput of an LLM
    variant on n cards derived from the analytic roofline of one NVIDIA
    H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), cross-calibrated
    against measured variants by ``repro_torch.profiling.calibrate``. The
    formulas are the reference package's (its TPU roofline); only the
    per-card constants are the H100's.
  * ``measured`` — ``repro_torch.profiling.measure.EngineProfiler``:
    profiles regression-fitted from the port's ``InProcessServingEngine``.

``paper_resnet_profiles``/``variant_ladder_profiles`` accept an optional
``store`` (duck-typed ``ProfileStore``) and register what they build.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

# NVIDIA H100 SXM constants (per card, data sheet, at 700 W): dense bf16
# tensor-core peak and HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12


@dataclass(frozen=True)
class VariantProfile:
    """Profiled/predicted behaviour of one model variant."""
    name: str
    accuracy: float            # % (or quality-proxy score)
    rt: float                  # readiness time (load+init), seconds
    th_slope: float            # RPS per resource unit
    th_intercept: float        # RPS
    lat_base_ms: float         # floor latency
    lat_k_ms: float            # p(n) = lat_base + lat_k / n
    max_units: int = 64

    def throughput(self, n: int) -> float:
        if n <= 0:
            return 0.0
        return max(0.0, self.th_slope * n + self.th_intercept)

    def p99_ms(self, n: int) -> float:
        if n <= 0:
            return float("inf")
        return self.lat_base_ms + self.lat_k_ms / n

    def min_feasible_units(self, slo_ms: float) -> Optional[int]:
        """Smallest allocation meeting the latency SLO, or None."""
        if self.lat_base_ms >= slo_ms:
            return None
        n = int(np.ceil(self.lat_k_ms / max(slo_ms - self.lat_base_ms, 1e-9)))
        return max(1, n)


@dataclass
class LinearRegressionFit:
    """Least-squares fit of throughput profiles (reproduces paper Fig. 6)."""
    slope: float
    intercept: float
    r_squared: float
    points: List[Tuple[int, float]] = field(default_factory=list)


def fit_throughput(points: Sequence[Tuple[int, float]]) -> LinearRegressionFit:
    ns = np.array([p[0] for p in points], float)
    th = np.array([p[1] for p in points], float)
    A = np.stack([ns, np.ones_like(ns)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, th, rcond=None)
    pred = slope * ns + intercept
    ss_res = float(np.sum((th - pred) ** 2))
    ss_tot = float(np.sum((th - np.mean(th)) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return LinearRegressionFit(float(slope), float(intercept), r2, list(points))


# ---------------------------------------------------------------------------
# Paper-calibrated ResNet profiles (CPU cores as the resource unit)
# ---------------------------------------------------------------------------
# Ground-truth linear profiles th(n) = a·n + b calibrated to satisfy the
# paper's reported relations (see tests/test_profiles.py):
#   * th_18(8)  ≈ th_50(20)   (Fig. 1 observation)
#   * th_50(8)  ≈ th_152(20)  (Fig. 1 observation, looser)
#   * th_50(2) + th_101(6) + th_152(6) ≥ 75 RPS  (Fig. 2's chosen config)
#   * th_50(14) ≥ 75 > th_101(14)  (so MS's best single variant at B=14 is R50)
_RESNET_TRUTH = {
    #            a      b     lat_base  lat_k    acc     rt
    "resnet18": (13.0, 15.0, 25.0, 110.0, 69.76, 4.0),
    "resnet34": (8.5, 12.0, 38.0, 180.0, 73.31, 6.0),
    "resnet50": (5.0, 10.0, 55.0, 300.0, 76.13, 8.0),
    "resnet101": (4.0, 8.0, 85.0, 520.0, 77.37, 12.0),
    "resnet152": (3.2, 5.0, 110.0, 740.0, 78.31, 15.0),
}
PROFILE_CORE_POINTS = (1, 2, 4, 8, 16)  # the paper profiles only these


def measured_resnet_points(name: str, noise: float = 0.0,
                           seed: int = 0) -> List[Tuple[int, float]]:
    """Synthetic 'measured' profile points at the paper's 5 allocations."""
    a, b, *_ = _RESNET_TRUTH[name]
    rng = np.random.default_rng(seed + hash(name) % 1000)
    pts = []
    for n in PROFILE_CORE_POINTS:
        th = a * n + b
        if noise:
            th *= 1.0 + rng.normal(0.0, noise)
        pts.append((n, max(th, 0.0)))
    return pts


def paper_resnet_profiles(noise: float = 0.01, seed: int = 0,
                          store=None) -> Dict[str, VariantProfile]:
    """The paper's five-variant family with regression-fitted throughput.

    With ``store`` (a ``repro_torch.profiling.store.ProfileStore``) every
    profile is registered under provenance ``"paper-calibrated"`` with its
    fit."""
    out = {}
    for name, (a, b, lb, lk, acc, rt) in _RESNET_TRUTH.items():
        fit = fit_throughput(measured_resnet_points(name, noise, seed))
        out[name] = VariantProfile(
            name=name, accuracy=acc, rt=rt,
            th_slope=fit.slope, th_intercept=fit.intercept,
            lat_base_ms=lb, lat_k_ms=lk)
        if store is not None:
            store.register(out[name], "paper-calibrated", fit=fit)
    return out


# ---------------------------------------------------------------------------
# Roofline-derived profiles for LLM variant ladders (H100 constants)
# ---------------------------------------------------------------------------

def roofline_decode_tokens_per_s(cfg: ModelConfig, n_chips: int,
                                 batch: int = 8, kv_len: int = 2048,
                                 mfu: float = 0.4, hbm_eff: float = 0.7) -> float:
    """Decode throughput bound on n cards: min(compute, weight+KV streaming)."""
    n_active = cfg.active_param_count()
    flops_per_tok = 2.0 * n_active
    compute = n_chips * PEAK_FLOPS_BF16 * mfu / flops_per_tok * batch
    bytes_per_step = 2.0 * n_active  # weights streamed once per step (bf16)
    KV, hd, L = max(cfg.num_kv_heads, 1), cfg.resolved_head_dim, cfg.num_layers
    if cfg.family != "ssm":
        bytes_per_step += 2 * batch * kv_len * KV * hd * L * 2
    memory = n_chips * HBM_BW * hbm_eff / bytes_per_step * batch
    return min(compute, memory)


def roofline_profile(cfg: ModelConfig, accuracy: float, *,
                     tokens_per_request: int = 128, max_chips: int = 64,
                     ) -> VariantProfile:
    """Linear-regression profile over card counts (the paper's methodology)."""
    pts = []
    for n in PROFILE_CORE_POINTS:
        rps = roofline_decode_tokens_per_s(cfg, n) / tokens_per_request
        pts.append((n, rps))
    fit = fit_throughput(pts)
    # latency: time to generate one request's tokens at per-card rate
    tok_s_1 = roofline_decode_tokens_per_s(cfg, 1)
    lat_k = tokens_per_request / max(tok_s_1, 1e-9) * 1000.0
    # readiness: HBM fill time for the weights + compile slack
    load_s = 2.0 * cfg.param_count() / HBM_BW + 2.0
    return VariantProfile(
        name=cfg.name, accuracy=accuracy, rt=load_s,
        th_slope=fit.slope, th_intercept=fit.intercept,
        lat_base_ms=5.0, lat_k_ms=lat_k, max_units=max_chips)


def variant_ladder_profiles(base: ModelConfig, *, fractions=(0.25, 0.5, 0.75, 1.0),
                            acc_max: float = 80.0, acc_span: float = 12.0,
                            store=None) -> Dict[str, VariantProfile]:
    """Depth-scaled variant family for an assigned arch + scaling-law accuracy
    proxy acc(N) = acc_max - acc_span · (N/N_full)^(-0.28) + acc_span
    (documented proxy — monotone in N with diminishing returns).

    With ``store`` every profile is registered under provenance
    ``"roofline"`` (analytic, not measured)."""
    out = {}
    n_full = base.param_count()
    for f in fractions:
        L = max(2, int(round(base.num_layers * f)))
        cfg = base.replace(name=f"{base.name}-L{L}", num_layers=L)
        ratio = cfg.param_count() / n_full
        acc = acc_max - acc_span * (ratio ** -0.28 - 1.0) - acc_span * 0.0
        acc = float(np.clip(acc, 1.0, 99.9))
        out[cfg.name] = roofline_profile(cfg, acc)
        if store is not None:
            store.register(out[cfg.name], "roofline",
                           meta={"base": base.name, "fraction": f})
    return out

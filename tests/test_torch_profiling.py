"""The port's profiles and profiling modules on their own, against the
reference: the mirrors of tests/test_profiles.py and
tests/test_profile_store.py on ``repro_torch``, the copied ``store``,
``drift`` and ``calibrate`` modules held equal to the reference's source
modulo the package name, the fit functions equal to the reference's on
seeded random points, the roofline equal to the reference's under the
reference's TPU v5e constants and to a hand-computed value under the H100's,
stores saved by either package loaded by the other, and equal drift reports
from one observation stream. The engine-driven cases are in
tests/test_torch_profiling_engine.py."""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from _torch_parity import port_config
from repro_torch.configs import get_config
from repro_torch.core import profiles as port_profiles
from repro_torch.core.profiles import (fit_throughput, measured_resnet_points,
                                       paper_resnet_profiles,
                                       roofline_decode_tokens_per_s,
                                       roofline_profile,
                                       variant_ladder_profiles,
                                       VariantProfile)
from repro_torch.profiling.store import (PROVENANCES, SCHEMA_VERSION,
                                         ProfileStore)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ no drift
@pytest.mark.parametrize("module", ["store", "drift", "calibrate"])
def test_copied_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/profiling" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/profiling" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


# ------------------------------------------------- tests/test_profiles.py
def test_paper_relations_hold():
    p = paper_resnet_profiles(noise=0.0)
    # Fig.1: R18@8 ~ R50@20 (within 10%)
    assert abs(p["resnet18"].throughput(8) - p["resnet50"].throughput(20)) \
        / p["resnet50"].throughput(20) < 0.10
    # Fig.2 feasibility: {R50:2, R101:6, R152:6} sustains 75 RPS
    cap = (p["resnet50"].throughput(2) + p["resnet101"].throughput(6)
           + p["resnet152"].throughput(6))
    assert cap >= 75.0
    # MS's best single variant at B=14 for 75 RPS is R50
    assert p["resnet50"].throughput(14) >= 75.0
    assert p["resnet101"].throughput(14) < 75.0
    assert p["resnet152"].throughput(14) < 75.0


def test_latency_model_monotone():
    p = paper_resnet_profiles(noise=0.0)["resnet152"]
    lats = [p.p99_ms(n) for n in range(1, 20)]
    assert all(a >= b for a, b in zip(lats, lats[1:]))
    assert p.min_feasible_units(750.0) is not None
    assert p.p99_ms(p.min_feasible_units(750.0)) <= 750.0


def test_regression_fit():
    fit = fit_throughput(measured_resnet_points("resnet18", noise=0.0))
    assert fit.r_squared > 0.999
    assert abs(fit.slope - 13.0) < 0.2


def test_regression_fit_r2_bounded_under_noise():
    """R² stays a valid confidence signal in [0, 1] at any noise level."""
    for name in ("resnet18", "resnet50", "resnet152"):
        for noise in (0.0, 0.02, 0.1, 0.5):
            for seed in range(5):
                fit = fit_throughput(
                    measured_resnet_points(name, noise=noise, seed=seed))
                assert 0.0 <= fit.r_squared <= 1.0
    noisy = [fit_throughput(measured_resnet_points("resnet18", noise=0.5,
                                                   seed=s)).r_squared
             for s in range(8)]
    assert min(noisy) < 0.999


def test_regression_fit_slope_recovery():
    """Clean data recovers every family's calibrated (slope, intercept);
    mild measurement noise keeps the slope within a sane band."""
    for name, (a, b, *_rest) in port_profiles._RESNET_TRUTH.items():
        fit = fit_throughput(measured_resnet_points(name, noise=0.0))
        assert abs(fit.slope - a) < 1e-6
        assert abs(fit.intercept - b) < 1e-6
        assert fit.points == measured_resnet_points(name, noise=0.0)
        noisy = fit_throughput(measured_resnet_points(name, noise=0.02, seed=3))
        assert abs(noisy.slope - a) / a < 0.25


def test_roofline_profile_monotone_in_chips():
    cfg = get_config("tinyllama-1.1b")
    prof = roofline_profile(cfg, accuracy=70.0)
    assert prof.throughput(8) > prof.throughput(1)
    assert prof.rt > 0


def test_roofline_batching_helps_decode():
    """Decode throughput grows with batch (bandwidth-bound)."""
    cfg = get_config("tinyllama-1.1b")
    t1 = roofline_decode_tokens_per_s(cfg, 1, batch=1)
    t32 = roofline_decode_tokens_per_s(cfg, 1, batch=32)
    assert t32 > 4 * t1


def test_variant_ladder_accuracy_monotone():
    # yi-6b is not in the port's registry yet (ROADMAP A16): its config is
    # the reference's, carried field by field
    from repro.configs import get_config as ref_config
    cfg = port_config(ref_config("yi-6b"))
    store = ProfileStore()
    ladder = variant_ladder_profiles(cfg, store=store)
    assert all(store.entry(n).provenance == "roofline" for n in ladder)
    profs = sorted(ladder.values(), key=lambda p: p.accuracy)
    # deeper (more params) -> more accurate, slower
    assert profs[0].th_slope >= profs[-1].th_slope * 0.9
    assert len({p.accuracy for p in profs}) == len(profs)


# -------------------------------------------- tests/test_profile_store.py
def _profile(name="v0"):
    return VariantProfile(name=name, accuracy=71.3, rt=3.25,
                          th_slope=12.125, th_intercept=1.75,
                          lat_base_ms=25.5, lat_k_ms=110.0, max_units=32)


def test_roundtrip_identical(tmp_path):
    """save -> load reproduces bit-identical VariantProfile dataclasses."""
    store = ProfileStore(str(tmp_path / "s.json"))
    fit = fit_throughput(measured_resnet_points("resnet18", noise=0.02))
    store.register(_profile(), "measured", fit=fit, meta={"note": "t"})
    store.register(_profile("v1"), "roofline")
    path = store.save()
    loaded = ProfileStore.load(path)
    assert loaded.names() == ["v0", "v1"]
    assert loaded.get("v0") == _profile()
    assert loaded.get("v1") == _profile("v1")
    e = loaded.entry("v0")
    assert e.provenance == "measured"
    assert e.meta == {"note": "t"}
    assert e.updated_at == store.entry("v0").updated_at
    assert e.fit.slope == fit.slope and e.fit.r_squared == fit.r_squared
    assert e.fit.points == fit.points
    p2 = loaded.save(str(tmp_path / "s2.json"))
    assert ProfileStore.load(p2).get("v0") == _profile()


def test_provenance_validation_and_supersede():
    store = ProfileStore()
    with pytest.raises(ValueError):
        store.register(_profile(), "guessed")
    assert set(PROVENANCES) == {"measured", "roofline", "paper-calibrated"}
    store.register(_profile(), "paper-calibrated")
    e = store.register(_profile(), "measured")     # re-measurement overwrites
    assert e.meta["superseded"] == "paper-calibrated"
    assert store.entry("v0").provenance == "measured"


def test_schema_version_enforced(tmp_path):
    store = ProfileStore(str(tmp_path / "s.json"))
    store.register(_profile(), "measured")
    path = store.save()
    doc = json.load(open(path))
    assert doc["schema_version"] == SCHEMA_VERSION
    doc["schema_version"] = SCHEMA_VERSION + 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="schema_version"):
        ProfileStore.load(str(bad))


def test_paper_profiles_register(tmp_path):
    store = ProfileStore(str(tmp_path / "resnet.json"))
    profs = paper_resnet_profiles(noise=0.01, seed=0, store=store)
    assert len(store) == 5
    loaded = ProfileStore.load(store.save())
    for name, p in profs.items():
        assert loaded.get(name) == p
        assert loaded.entry(name).provenance == "paper-calibrated"
        assert loaded.entry(name).fit is not None


# ------------------------------------------------ fits against the reference
@pytest.mark.parametrize("seed", range(4))
def test_fit_functions_equal_reference(seed):
    from repro.core.profiles import fit_throughput as ref_fit_throughput
    from repro.profiling.measure import fit_latency as ref_fit_latency
    from repro_torch.profiling.measure import fit_latency
    rng = np.random.default_rng(seed)
    for n_pts in (1, 2, 3, 5):
        ns = sorted(rng.choice([1, 2, 4, 8, 16], n_pts, replace=False))
        th = [(int(n), float(v)) for n, v in
              zip(ns, rng.uniform(0.1, 50.0, n_pts))]
        lat = [(int(n), float(v)) for n, v in
               zip(ns, rng.uniform(5.0, 500.0, n_pts))]
        if n_pts >= 2:
            got, want = fit_throughput(th), ref_fit_throughput(th)
            np.testing.assert_allclose(
                [got.slope, got.intercept, got.r_squared],
                [want.slope, want.intercept, want.r_squared], rtol=1e-12)
            assert got.points == want.points
        np.testing.assert_allclose(fit_latency(lat), ref_fit_latency(lat),
                                   rtol=1e-12)


# ------------------------------------------------- roofline against both
def _roofline_cfgs():
    from repro.configs import get_config as ref_config
    from repro.configs import smoke_variant as ref_smoke
    out = []
    for arch in ("tinyllama-1.1b", "mamba2-130m", "hymba-1.5b"):
        out += [(arch, ref_config(arch)), (f"{arch}-smoke",
                                          ref_smoke(ref_config(arch)))]
    return out


@pytest.mark.parametrize("label,jcfg", _roofline_cfgs(),
                         ids=[c[0] for c in _roofline_cfgs()])
def test_roofline_equals_reference_under_its_constants(label, jcfg,
                                                       monkeypatch):
    """Under the reference's TPU v5e constants the port's roofline is the
    reference's: same formulas, only the per-card constants differ."""
    from repro.core import profiles as ref
    monkeypatch.setattr(port_profiles, "PEAK_FLOPS_BF16", 197e12)
    monkeypatch.setattr(port_profiles, "HBM_BW", 819e9)
    cfg = port_config(jcfg)
    for n in (1, 4, 16):
        for kw in ({}, dict(batch=1), dict(batch=32, kv_len=512)):
            np.testing.assert_allclose(
                port_profiles.roofline_decode_tokens_per_s(cfg, n, **kw),
                ref.roofline_decode_tokens_per_s(jcfg, n, **kw), rtol=1e-12)
    for tpr in (128, 64):
        got = dataclasses.asdict(port_profiles.roofline_profile(
            cfg, 71.0, tokens_per_request=tpr))
        want = dataclasses.asdict(ref.roofline_profile(
            jcfg, 71.0, tokens_per_request=tpr))
        assert got.keys() == want.keys() and got["name"] == want["name"]
        for k in got:
            if k != "name":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           err_msg=k)
    got = port_profiles.variant_ladder_profiles(cfg)
    want = ref.variant_ladder_profiles(jcfg)
    assert list(got) == list(want)
    for name in got:
        g, w = dataclasses.asdict(got[name]), dataclasses.asdict(want[name])
        np.testing.assert_allclose([g[k] for k in g if k != "name"],
                                   [w[k] for k in w if k != "name"],
                                   rtol=1e-12)


def test_roofline_h100_hand_value():
    """tinyllama-1.1b at batch 8, kv_len 2048 on one H100 SXM: the weights
    and the KV cache streamed once a step at 70% of 3.35 TB/s bound the
    decode rate (compute at 40% of 989 TFLOP/s allows ~197x more)."""
    assert (port_profiles.PEAK_FLOPS_BF16, port_profiles.HBM_BW) == (
        989e12, 3.35e12)
    cfg = get_config("tinyllama-1.1b")
    D, F, L, H, KV, hd, V = 2048, 5632, 22, 32, 4, 64, 32000
    per_layer = (D * H * hd + 2 * D * KV * hd + H * hd * D   # q, k, v, o
                 + 3 * D * F + 2 * D)                         # SwiGLU, norms
    params = 2 * V * D + L * per_layer                        # + embed, head
    assert params == 1_100_046_336 == cfg.param_count()
    step_bytes = 2 * params + 2 * 8 * 2048 * KV * hd * L * 2  # bf16 W, K+V
    assert step_bytes == 2_569_191_424
    memory = 3.35e12 * 0.7 / step_bytes * 8                  # ≈ 7301.9 tok/s
    compute = 989e12 * 0.4 / (2 * params) * 8
    assert compute > 100 * memory
    got = roofline_decode_tokens_per_s(cfg, 1)
    assert got == pytest.approx(memory, rel=1e-12)
    assert 7301 < got < 7302
    prof = roofline_profile(cfg, 70.0, tokens_per_request=64)
    # linear in n (no compute cap up to 16 cards): slope = rate / 64 tokens
    assert prof.th_slope == pytest.approx(memory / 64, rel=1e-9)
    assert prof.th_intercept == pytest.approx(0.0, abs=1e-9)
    assert prof.lat_k_ms == pytest.approx(64 / memory * 1e3, rel=1e-12)
    assert prof.rt == pytest.approx(2 * params / 3.35e12 + 2.0, rel=1e-12)


# ------------------------------------------ stores across the two packages
def _both_stores(tmp_path):
    from repro.core.profiles import VariantProfile as RefProfile
    from repro.core.profiles import fit_throughput as ref_fit
    from repro.profiling.store import ProfileStore as RefStore
    pts = measured_resnet_points("resnet50", noise=0.02)
    out = {}
    for tag, (Store, Prof, fit) in {
            "port": (ProfileStore, VariantProfile, fit_throughput),
            "ref": (RefStore, RefProfile, ref_fit)}.items():
        s = Store(str(tmp_path / f"{tag}.json"))
        s.register(Prof(**dataclasses.asdict(_profile("a"))), "measured",
                   fit=fit(pts), meta={"mean_latency_model": [1.5, 2.5]},
                   updated_at=123.25)
        s.register(Prof(**dataclasses.asdict(_profile("b"))), "roofline",
                   meta={"calibration_scale": 0.03})
        s.register(Prof(**dataclasses.asdict(_profile("c"))),
                   "paper-calibrated")
        out[tag] = s
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_loads_across_packages(writer, tmp_path):
    """A store saved by either package loads in the other with equal
    profiles, provenances, fits and meta, and the two packages write the
    same document."""
    from repro.profiling.store import ProfileStore as RefStore
    stores = _both_stores(tmp_path)
    path = stores[writer].save()
    Reader = RefStore if writer == "port" else ProfileStore
    got, src = Reader.load(path), stores[writer]
    assert got.names() == src.names() == ["a", "b", "c"]
    for n in src.names():
        e, s = got.entry(n), src.entry(n)
        assert dataclasses.asdict(e.profile) == dataclasses.asdict(s.profile)
        assert (e.provenance, e.updated_at, e.meta) == (
            s.provenance, s.updated_at, s.meta)
        assert (e.fit is None) == (s.fit is None)
        if e.fit is not None:
            assert dataclasses.asdict(e.fit) == dataclasses.asdict(s.fit)
    docs = {t: s.to_json() for t, s in stores.items()}
    for d in docs.values():
        d["profiles"]["b"].pop("updated_at")
        d["profiles"]["c"].pop("updated_at")
    assert docs["port"] == docs["ref"]


# ------------------------------------------------ drift reports, both sides
def test_drift_reports_equal_reference():
    """One observation stream through both detectors (a store source with
    a mean-latency model, a plain mapping without one, the throughput band
    on and off): equal reports at every check, before and after a reset."""
    from repro.core.profiles import VariantProfile as RefProfile
    from repro.profiling.drift import DriftDetector as RefDetector
    from repro.profiling.store import ProfileStore as RefStore
    from repro_torch.profiling.drift import DriftDetector
    rng = np.random.default_rng(0)
    prof = dict(name="m", accuracy=70.0, rt=1.0, th_slope=4.0,
                th_intercept=0.5, lat_base_ms=40.0, lat_k_ms=120.0)
    stream = []
    t = 100.0
    for i in range(60):
        t += float(rng.exponential(0.1))
        slow = 3.0 if i >= 30 else 1.0
        stream.append(SimpleNamespace(
            backend="m" if i % 5 else "other",
            service_ms=float(rng.uniform(40.0, 120.0)) * slow, completion=t))
    stream.append(SimpleNamespace(backend="", service_ms=1.0, completion=t))
    for band in (None, 0.2):
        dets = []
        for Store, Prof, Det in ((ProfileStore, VariantProfile,
                                  DriftDetector),
                                 (RefStore, RefProfile, RefDetector)):
            s = Store()
            s.register(Prof(**prof), "measured",
                       meta={"mean_latency_model": [30.0, 60.0]})
            s.register(Prof(**dict(prof, name="other")), "roofline")
            dets.append(Det(s, tolerance=0.35, min_requests=5, window=16,
                            throughput_band=band))
        mapping = [Det({"m": Prof(**prof)}, min_requests=3)
                   for Prof, Det in ((VariantProfile, DriftDetector),
                                     (RefProfile, RefDetector))]
        for i, r in enumerate(stream):
            for d in dets + mapping:
                d.observe(r)
            if i % 7 == 0:
                for pair in (dets, mapping):
                    for units in (1, 2, 4):
                        a, b = (d.check_all({"m": units, "other": units,
                                             "none": units, "zero": 0})
                                for d in pair)
                        assert [dataclasses.asdict(x) for x in a] == \
                            [dataclasses.asdict(x) for x in b]
            if i == 40:
                for d in dets:
                    d.reset("m")

"""Persistent, versioned variant-profile store.

The paper's Adapter consumes profiles as static inputs; INFaaS
(arXiv 1905.13348) showed that model-less serving at scale needs a
first-class *registry* of variant profiles instead. This module is that
registry: every ``VariantProfile`` the system knows about lives here,
tagged with

  * **provenance** — how the numbers were obtained: ``"measured"`` (the
    offline ``EngineProfiler`` ran the real engine), ``"roofline"``
    (analytic TPU roofline, optionally cross-calibrated), or
    ``"paper-calibrated"`` (the paper's ResNet constants);
  * the **regression fit** behind the throughput line (slope/intercept/R²
    and the raw (n, th) points), so confidence is auditable; and
  * free-form ``meta`` (calibration scale factors, recalibration history).

The on-disk form is a single versioned JSON document (default location
``reports/profiles/``); ``save``/``load`` round-trip exactly — JSON floats
preserve the shortest-repr encoding, so ``load(save(store))`` reproduces
bit-identical ``VariantProfile`` dataclasses (tested).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.profiles import LinearRegressionFit, VariantProfile

SCHEMA_VERSION = 1
PROVENANCES = ("measured", "roofline", "paper-calibrated")
DEFAULT_STORE_DIR = os.path.join("reports", "profiles")
DEFAULT_STORE_PATH = os.path.join(DEFAULT_STORE_DIR, "profiles.json")


@dataclass
class StoredProfile:
    """One registry entry: the profile + how we know it."""
    profile: VariantProfile
    provenance: str
    updated_at: float
    fit: Optional[LinearRegressionFit] = None
    meta: Dict = field(default_factory=dict)


class ProfileStore:
    """Name -> ``StoredProfile`` registry with JSON persistence.

    ``register`` upserts (a re-measurement overwrites the stale entry and
    records the previous provenance in ``meta["superseded"]``);
    ``profiles()`` is the view controllers/solvers consume.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or DEFAULT_STORE_PATH
        self._entries: Dict[str, StoredProfile] = {}

    # ------------------------------------------------------------- registry
    def register(self, profile: VariantProfile, provenance: str, *,
                 fit: Optional[LinearRegressionFit] = None,
                 meta: Optional[Dict] = None,
                 updated_at: Optional[float] = None) -> StoredProfile:
        if provenance not in PROVENANCES:
            raise ValueError(f"unknown provenance {provenance!r} "
                             f"(expected one of {PROVENANCES})")
        meta = dict(meta or {})
        prev = self._entries.get(profile.name)
        if prev is not None and prev.provenance != provenance:
            meta.setdefault("superseded", prev.provenance)
        entry = StoredProfile(profile=profile, provenance=provenance,
                              updated_at=updated_at if updated_at is not None
                              else time.time(), fit=fit, meta=meta)
        self._entries[profile.name] = entry
        return entry

    def get(self, name: str) -> VariantProfile:
        return self._entries[name].profile

    def entry(self, name: str) -> StoredProfile:
        return self._entries[name]

    def profiles(self) -> Dict[str, VariantProfile]:
        """The plain name -> profile mapping solvers/controllers take."""
        return {n: e.profile for n, e in self._entries.items()}

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # ---------------------------------------------------------- persistence
    def to_json(self) -> Dict:
        doc = {"schema_version": SCHEMA_VERSION, "profiles": {}}
        for name, e in sorted(self._entries.items()):
            rec = {
                "profile": dataclasses.asdict(e.profile),
                "provenance": e.provenance,
                "updated_at": e.updated_at,
                "meta": e.meta,
            }
            if e.fit is not None:
                rec["fit"] = {
                    "slope": e.fit.slope, "intercept": e.fit.intercept,
                    "r_squared": e.fit.r_squared,
                    "points": [[int(n), float(th)] for n, th in e.fit.points],
                }
            doc["profiles"][name] = rec
        return doc

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        self.path = path
        return path

    @classmethod
    def from_json(cls, doc: Dict, path: Optional[str] = None) -> "ProfileStore":
        ver = doc.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise ValueError(f"profile store schema_version {ver!r} "
                             f"unsupported (expected {SCHEMA_VERSION})")
        store = cls(path=path)
        for name, rec in doc.get("profiles", {}).items():
            prof = VariantProfile(**rec["profile"])
            fit = None
            if "fit" in rec:
                f = rec["fit"]
                pts: List[Tuple[int, float]] = [
                    (int(n), float(th)) for n, th in f.get("points", [])]
                fit = LinearRegressionFit(f["slope"], f["intercept"],
                                          f["r_squared"], pts)
            store.register(prof, rec["provenance"], fit=fit,
                           meta=rec.get("meta", {}),
                           updated_at=rec.get("updated_at", 0.0))
        return store

    @classmethod
    def load(cls, path: str) -> "ProfileStore":
        with open(path) as f:
            return cls.from_json(json.load(f), path=path)

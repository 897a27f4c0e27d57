"""Measured profiling subsystem on the port's engine: engine-driven variant
profiles, a persistent profile store, drift detection with online
recalibration, and the roofline cross-calibration (the paper's §5
Profiler).

The store, drift and calibration modules are copies of the reference
package's (numpy only); the offline profiler (``measure``) drives the
port's torch engine and is imported only where it is used.
"""
from repro_torch.profiling.store import (DEFAULT_STORE_DIR,  # noqa: F401
                                         DEFAULT_STORE_PATH, PROVENANCES,
                                         SCHEMA_VERSION, ProfileStore,
                                         StoredProfile)
from repro_torch.profiling.drift import (DriftDetector,  # noqa: F401
                                         DriftReport, OnlineRecalibrator)

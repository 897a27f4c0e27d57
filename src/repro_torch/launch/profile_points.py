"""Where a profiled allocation point's time goes, point by point.

Builds the deepest rung of the tinyllama-1.1b ladder (``launch.serve``:
smoke by default, ``--full-width`` for the published L22 in bf16 at the
serve geometry) as a fresh throwaway backend for each ``--orders`` entry,
and measures its points in that order with ``EngineProfiler``'s own
``_measure_point`` (16 requests a point after 4 warm-up requests), every
decode chunk fenced (``VariantBackend._fence_exec``: ``dispatch_ms`` is
the host's enqueue of the chunk, ``device_ms`` its wait until the card
finished it). On a card ``nvidia-smi`` samples the SM clock, power and
throttle reasons every 100 ms, reported per point. One JSON line per
point, so the same cap measured first and later in a backend's life can
be compared.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_points --full-width \
      [--kv-cache paged] [--orders 1,2,4,8,1 8,4,2,1]
  PYTHONPATH=src python -m repro_torch.launch.profile_points --device cpu
"""
from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time

import numpy as np

from repro_torch.launch.serve import GEOMETRY, build_ladder
from repro_torch.profiling.measure import EngineProfiler
from repro_torch.serving.engine import InProcessServingEngine

REQUESTS_PER_POINT = 16
SMI_FIELDS = ("clocks.sm", "power.draw", "clocks_throttle_reasons.active")


class _ClockSampler:
    """``nvidia-smi`` every 100 ms on a reader thread: (time, sm MHz,
    power W, throttle reasons) samples."""

    def __init__(self):
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self._proc.stdout:
            sm, power, reasons = (v.strip() for v in line.split(","))
            self.samples.append((time.time(), float(sm), float(power),
                                 reasons))

    def between(self, t0: float, t1: float) -> dict:
        got = [s for s in self.samples if t0 <= s[0] <= t1]
        if not got:
            return {"smi_samples": 0}
        sm = [s[1] for s in got]
        return {"smi_samples": len(got), "sm_mhz_mean": float(np.mean(sm)),
                "sm_mhz_min": min(sm), "sm_mhz_max": max(sm),
                "power_w_mean": float(np.mean([s[2] for s in got])),
                "throttle": sorted({s[3] for s in got})}

    def close(self):
        self._proc.terminate()
        self._proc.wait(timeout=10)
        self._thread.join(timeout=10)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--kv-cache", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--orders", nargs="+", default=["1,2,4,8,1", "8,4,2,1"],
                    help="one comma-separated cap order per fresh backend")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> list:
    """Returns one dict per measured point, in run order."""
    args = parse_args(argv)
    variants = build_ladder("tinyllama-1.1b", full_width=args.full_width)
    top = max(variants, key=lambda n: variants[n][0].num_layers)
    geo = GEOMETRY[args.full_width]
    eng = InProcessServingEngine({top: variants[top]}, use_kernels=True,
                                 device=args.device, kv_cache=args.kv_cache,
                                 **geo)
    prof = EngineProfiler(eng, vocab=variants[top][0].vocab_size)
    smi = _ClockSampler() if eng.device.type == "cuda" else None
    rows = []
    try:
        for i, order in enumerate(args.orders):
            b = eng._make_backend(top)
            b._fence_exec = True
            splits = []
            exec_step = b._exec_step

            def fenced(*a, _exec=exec_step, _b=b, **kw):
                out = _exec(*a, **kw)
                splits.append(_b.exec_split)
                return out
            b._exec_step = fenced
            for cap in (int(c) for c in order.split(",")):
                splits.clear()
                t0 = time.time()
                pt = prof._measure_point(b, cap, REQUESTS_PER_POINT)
                t1 = time.time()
                s = np.array(splits, float)
                row = dict(backend=i, kv_cache=args.kv_cache, cap=cap,
                           rps=pt.throughput_rps, svc_ms=pt.mean_service_ms,
                           p99_ms=pt.p99_service_ms,
                           dispatch_ms=float(s[:, 0].mean()),
                           dispatch_max_ms=float(s[:, 0].max()),
                           device_ms=float(s[:, 1].mean()),
                           chunks=len(s), wall_s=t1 - t0)
                if smi is not None:
                    row.update(smi.between(t0, t1))
                rows.append(row)
                log(json.dumps(row))
            b.close()
    finally:
        if smi is not None:
            smi.close()
    return rows


if __name__ == "__main__":
    main()

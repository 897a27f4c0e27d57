"""``BENCHMARK.json`` and the data files of one cell, found by name."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<mix>.json
    geometry: Dict        # cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files; a
    missing cell or file raises (KeyError, FileNotFoundError)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "perfbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        geometry=json.loads((bench / "cells" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        root=root)

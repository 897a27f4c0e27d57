"""A benchmark root at a size the CPU runs in seconds: the real
``BENCHMARK.json`` with smoke cells added as data files only (a
configuration, a traffic mix and a cell file each), in a copy of the
benchmark's data folders."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.spec import ROOT

MOE = {"family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 97,
       "num_experts": 4, "experts_per_token": 2,
       "moe_capacity_factor": 2.0, "rope_theta": 10000.0,
       "norm_eps": 1e-06, "mlp_type": "swiglu", "tie_embeddings": False,
       "dtype": "float32"}
DENSE = {"family": "vlm", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 1, "head_dim": 16, "d_ff": 96, "vocab_size": 101,
         "rope_theta": 1000000.0, "norm_eps": 1e-06, "mlp_type": "swiglu",
         "tie_embeddings": False, "dtype": "float32"}
GEOMETRY = {"max_batch": 4, "prompt_len": 16, "max_new": 6,
            "decode_chunk": 2, "check_rows": 16,
            "limits": {"max_logit_gap": 1e-3, "tokens_compared": 40}}
CLOSED = {"loop": "closed", "clients_per_slot": 2, "block": 8,
          "prompt_tokens": {"dist": "log_normal", "median": 8,
                            "sigma": 0.7, "lo": 2},
          "output_tokens": {"dist": "log_normal", "median": 4,
                            "sigma": 0.5, "lo": 2}}
OPEN = dict(CLOSED, loop="open")


def make_root(tmp: Path) -> Path:
    """``tmp`` as a benchmark root: BENCHMARK.json with the smoke cells
    ``smoke-moe.saturate``, ``smoke-dense.saturate`` and
    ``smoke-moe.steady`` added, and their files."""
    for d in ("configs", "traffic", "cells", "metrics", "roofline"):
        shutil.copytree(ROOT / "perfbench" / d, tmp / "perfbench" / d)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, model in (("smoke-moe", MOE), ("smoke-dense", DENSE)):
        f = f"perfbench/configs/{name}.json"
        (tmp / f).write_text(json.dumps({"name": name, "model": model}))
        spec["configs"].append({"name": name, "source": "test", "file": f,
                                "reduced": [], "why": "test"})
    (tmp / "perfbench/traffic/smoke-closed.json").write_text(
        json.dumps(CLOSED))
    (tmp / "perfbench/traffic/smoke-open.json").write_text(json.dumps(OPEN))
    for cell, cfg, mix, like in (
            ("smoke-moe.saturate", "smoke-moe", "smoke-closed",
             "granite-moe.saturate"),
            ("smoke-dense.saturate", "smoke-dense", "smoke-closed",
             "internvl2-26b.saturate"),
            ("smoke-moe.steady", "smoke-moe", "smoke-open",
             "granite-moe.steady")):
        (tmp / f"perfbench/cells/{cell}.json").write_text(json.dumps(
            dict(GEOMETRY, rate_per_s=20.0) if mix == "smoke-open"
            else GEOMETRY))
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": mix, "chips": 1, "why": "t"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp

"""Production-mesh dry run: the port of ``repro.launch.dryrun``.

For every (architecture × input shape) pair, on the single-pod 16×16 mesh
(256 devices) and the multi-pod 2×16×16 one (512), check that the
distribution config is coherent and record what one device would hold and
do, with nothing allocated: every tensor is a ``device="meta"`` tensor
(``launch.steps.input_specs``).

Per pair it applies ``adapt_config_for_shape``, the reference's dtypes
(bf16 compute; fp32 params when training, bf16 when serving) and its FSDP
rule (training, or serving weights above ``SERVE_FSDP_BYTES`` per device
under 16-way TP), and reports:

  * exact per-device bytes of params, optimizer state, cache and batch:
    the first device's shard shapes under the sharding policy
    (``sharding.policy.local_shape``, DTensor's ``Shard`` cut);
  * ``analytic_hbm_bytes`` and ``model_flops`` (``analysis.roofline``),
    and ``fits_h100_80gb`` (the analytic estimate under 80 GB);
  * the step's FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``
    over the step run on meta tensors at global shapes. Its Python loops
    run every layer and q-block, so the reference's ``scan_corrections``
    is not added. The counter counts products (matmuls, convolutions,
    attention), not elementwise work. Per device: the global count ÷ chips
    (``flops_split: "even_split"``); ``usefulness = model_flops / counted``;
  * bytes accessed and collective bytes: not measured (None). Meta
    tensors carry no fusion, so any byte count of the step would be an
    unfused bound, not what a kernel moves; and a step on meta DTensors
    over a fake process group shows no collective (a row-parallel product
    returns a ``Partial`` result, and ``CommDebugMode`` counts no
    collective until a redistribution);
  * the roofline terms with the H100's constants (peak and HBM rate from
    ``core.profiles``, ``roofline.NVLINK_BW``): the compute term; the
    memory and collective terms and ``dominant`` are None.

The policy and the counts need only the production geometry
(``launch.mesh.production_geometry``, the reference's ``AbstractMesh``):
the step runs on plain meta tensors, so no process group is made. The CLI
counts each distinct step once, in its own process (``run_one``'s
``counts``): a count depends on the mesh only through the MoE dispatch
groups.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      [--both-meshes] [--out reports/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import (ALL_ARCHS, SHAPES, adapt_config_for_shape,
                                 get_config, get_shape)
from repro_torch.core.profiles import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import batch_axes, production_geometry
from repro_torch.sharding.context import activation_sharding
from repro_torch.sharding.policy import (batch_specs, cache_specs,
                                         local_shape, param_specs,
                                         tree_map_with_path)

# Serving weights that exceed one device's memory under 16-way TP fall back
# to ZeRO-style extra sharding over the data axis (qwen3-moe-235b): the
# reference's threshold, kept so that both dry runs shard alike.
SERVE_FSDP_BYTES = 12e9
H100_HBM_BYTES = 80e9


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of the first device's shards of ``tree`` under ``specs``."""
    total = [0]

    def add(path, t, sp):
        n = 1
        for d in local_shape(tuple(t.shape), sp, mesh):
            n *= d
        total[0] += n * t.element_size()
    tree_map_with_path(add, tree, specs)
    return total[0]


def count_step(fn, args, mesh=None, batch_axes_=None) -> float:
    """FLOPs of ``fn(*args)`` on meta tensors by ``FlopCounterMode``, under
    the activation-sharding context of ``mesh`` when given."""
    flops = FlopCounterMode(display=False)
    if mesh is None:
        with flops:
            fn(*args)
    else:
        with activation_sharding(mesh, batch_axes_), flops:
            fn(*args)
    return float(flops.get_total_flops())


def _pair(arch: str, shape_name: str):
    """(cfg at the dry run's dtypes, shape, note); cfg None for a pair
    ``adapt_config_for_shape`` skips (the note is its reason)."""
    shape = get_shape(shape_name)
    cfg, note = adapt_config_for_shape(get_config(arch), shape)
    if cfg is None:
        return None, shape, note
    cfg = cfg.replace(dtype="bfloat16",
                      param_dtype="float32" if shape.kind == "train"
                      else "bfloat16")
    return cfg, shape, note


def _batch_sharding(cfg, shape, geo
                    ) -> Tuple[Optional[Tuple[str, ...]], int, Tuple]:
    """(batch axes, or None where the batch is replicated (long_500k);
    the batch shard count; the key of the step's count in ``run_one``'s
    ``counts``: the count depends on the mesh only through the MoE
    groups)."""
    gb = shape.global_batch
    bsz = 1
    for a in batch_axes(geo):
        bsz *= geo.shape[a]
    baxes = batch_axes(geo) if (gb % bsz == 0 and gb >= bsz) else None
    bshard = bsz if baxes else 1
    key = (cfg, shape.name, bshard if cfg.is_moe else None)
    return baxes, bshard, key


def layout(arch: str, shape_name: str, *, multi_pod: bool = False
           ) -> Tuple[Dict, Optional[Tuple]]:
    """(the pair's record of what needs no step run: per-device bytes,
    ``model_flops``, ``analytic_hbm_bytes``, the FSDP decision and the
    policy's report; its step as (fn, args, count key, batch axes)). The
    record alone, with step None, for a pair the config skips."""
    cfg, shape, note = _pair(arch, shape_name)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": note}, None
    geo = production_geometry(multi_pod=multi_pod)
    msize = geo.shape["model"]
    fn, args = steps_mod.input_specs(cfg, shape)
    params = args[0]
    assert all(t.device.type == "meta" for t in tree_leaves(args)
               if isinstance(t, torch.Tensor)), "a dry-run tensor left meta"
    param_bytes = _nbytes(params)
    fsdp = (shape.kind == "train" or param_bytes / msize > SERVE_FSDP_BYTES)
    pspecs, report = param_specs(cfg, params, geo, fsdp=fsdp)
    per_dev = {"params": _local_bytes(params, pspecs, geo),
               "opt": 0, "cache": 0, "batch": 0}
    if shape.kind == "train":
        opt = args[1]
        ospecs = type(opt)(step=(), mu=pspecs, nu=pspecs)
        per_dev["opt"] = _local_bytes(opt, ospecs, geo)
        bspecs = batch_specs(cfg, args[2], geo, shape.global_batch)
        per_dev["batch"] = _local_bytes(args[2], bspecs, geo)
    elif shape.kind == "prefill":
        bspecs = batch_specs(cfg, args[1], geo, shape.global_batch)
        per_dev["batch"] = _local_bytes(args[1], bspecs, geo)
    else:
        cspecs = cache_specs(cfg, args[1], geo, shape.global_batch)
        per_dev["cache"] = _local_bytes(args[1], cspecs, geo)
        tspecs = batch_specs(cfg, {"tokens": args[2]}, geo,
                             shape.global_batch)
        per_dev["batch"] = _local_bytes({"tokens": args[2]}, tspecs, geo)
    per_dev["total"] = sum(per_dev.values())

    baxes, bshard, key = _batch_sharding(cfg, shape, geo)
    notes = "; ".join(x for x in (
        note, "FLOPs counted by FlopCounterMode over every layer and "
        "q-block (no scan correction), products only; per device = global "
        "/ chips; bytes accessed and collective bytes not measured") if x)
    hbm_est = rl.analytic_hbm_bytes(
        cfg, shape, param_bytes_global=param_bytes, model_shard=msize,
        batch_shard=bshard,
        fsdp_shard=geo.shape.get("data", 1) if fsdp else 1,
        train=shape.kind == "train")
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in geo.sizes), "chips": geo.size,
           "notes": notes, "skipped": False,
           "per_device_bytes": per_dev,
           "flops_split": "even_split",
           "bytes_accessed": None,
           "collective_bytes": None,
           "not_measured": ["bytes_accessed", "collective_bytes"],
           "model_flops": rl.model_flops(cfg, shape),
           "analytic_hbm_bytes": hbm_est,
           "fits_h100_80gb": hbm_est < H100_HBM_BYTES,
           "fsdp": fsdp,
           "param_bytes_global": param_bytes,
           "sharding_fallbacks": report.fallbacks[:8],
           "n_sharded": len(report.sharded),
           "n_replicated": len(report.replicated)}
    return rec, (fn, args, key, baxes)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            counts: Optional[Dict] = None, verbose: bool = True) -> Dict:
    """One pair's record: ``layout``'s, the step's counted FLOPs and the
    roofline terms. The count is read from ``counts`` where it holds the
    step's key, else the step is counted and the count stored there."""
    t0 = time.time()
    rec, step = layout(arch, shape_name, multi_pod=multi_pod)
    if step is None:
        return rec
    fn, args, key, baxes = step
    if counts is None:
        counts = {}
    if key not in counts:
        counts[key] = count_step(fn, args,
                                 production_geometry(multi_pod=multi_pod),
                                 baxes)
    flops_global = counts[key]
    chips, mflops = rec["chips"], rec["model_flops"]
    out = rl.analyze(arch, shape_name, rec["mesh"], chips,
                     {"flops": flops_global / chips, "bytes accessed": None},
                     None, mflops,
                     memory_bytes=float(rec["per_device_bytes"]["total"]),
                     notes=rec["notes"], peak_flops=PEAK_FLOPS_BF16,
                     hbm_bw=HBM_BW, link_bw=rl.NVLINK_BW).to_dict()
    out.update(rec)
    out.update({"count_s": time.time() - t0,
                "flops_counted_global": flops_global})
    if verbose:
        per, hbm_est = rec["per_device_bytes"], rec["analytic_hbm_bytes"]
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: per-device "
              f"bytes params {per['params']} opt {per['opt']} cache "
              f"{per['cache']} batch {per['batch']} total "
              f"{per['total']}; hbm-est {hbm_est / 1e9:.2f} GB "
              f"({'fits' if rec['fits_h100_80gb'] else 'OVER'} 80 GB "
              f"H100); counted FLOPs {flops_global:.4e} global, "
              f"{flops_global / chips:.4e}/device (even split); "
              f"usefulness {out['usefulness']:.3f}; compute "
              f"{out['compute_s'] * 1e3:.3f} ms, memory and collective "
              f"not measured; {out['count_s']:.1f} s", flush=True)
    return out

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    counts: Dict = {}
    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    res = run_one(arch, shape, multi_pod=mp, counts=counts)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append(tag)
                    res = {"arch": arch, "shape": shape, "skipped": False,
                           "error": str(e)[:2000]}
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=str)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Checkpointing: save/restore trees of tensors (params + optimizer state):
the port of ``repro.train.checkpoint``, on the reference's on-disk layout.

Layout (one directory per step):
    <dir>/step_000000100/
        manifest.json      tree structure + leaf dtypes/shapes + metadata
        arrays.npz         leaf arrays keyed by flattened path

A leaf's key is its path joined by ``/``: a dict key as itself, a list or
tuple index as its number, a NamedTuple field as ``.`` + its name (the
reference's key for ``AdamState.step`` is ``opt/.step``). The same tree
gives the same keys in both packages, so a checkpoint either writes
restores in the other. numpy has no bfloat16: such a leaf is saved as its
exact float32 value and cast back on restore, which casts every array to
the dtype of the tree it restores into.

Atomic via write-to-tmp + rename.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import tree_unflatten


def _walk(tree, path=()):
    """(key path, leaf) pairs in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _walk(v, path + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "*"


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> str:
    """Save a tree checkpoint; returns the checkpoint path."""
    flat = {k: _to_numpy(v) for k, v in _walk(tree)}
    final = os.path.join(directory, f"step_{step:09d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "treedef": _describe(tree),
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (shapes validated): tensors
    on each ``like`` leaf's device in its dtype, numpy arrays where
    ``like`` holds other leaves."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = dict(_walk(like))
    if sorted(flat_like) != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(flat_like)
        raise ValueError(f"checkpoint structure mismatch: {sorted(missing)[:5]}")
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key, leaf in flat_like.items():
            arr = arrays[key]
            shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                          else np.shape(leaf))
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            if isinstance(leaf, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                       dtype=leaf.dtype))
            else:
                leaves.append(arr.astype(np.asarray(leaf).dtype))
    return tree_unflatten(like, leaves), manifest["metadata"]


def prune(directory: str, keep: int = 3) -> None:
    """Keep only the newest ``keep`` checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)

"""Divisibility-aware sharding policy (Megatron-style TP + data
parallelism): the port of ``repro.sharding.policy``.

Given a params tree (a dict of tensors; ``device="meta"`` leaves suffice)
and a mesh (``launch.mesh.AbstractMesh`` or a ``DeviceMesh``), produce a
spec tree by path-based rules with per-tensor divisibility fallbacks:

  * embeddings: vocab-sharded over "model" (vocab is padded to 256 so every
    assigned arch divides a 16-way axis);
  * attention QKV column-parallel over heads, O row-parallel — only when the
    (kv-)head count divides the model axis, else replicated on "model"
    (gemma-2b's 8 heads, hymba's 25, whisper's 6 fall back — recorded);
  * dense FFN up/gate column-parallel, down row-parallel over d_ff;
  * MoE experts expert-parallel when E divides the axis, else d_ff-sharded
    (granite's 40 experts on a 16-way axis fall back to d_ff);
  * SSM mixer params replicated (mamba2-130m is small; documented);
  * norms/scalars replicated.

KV caches are sharded batch→("pod","data") and cache-sequence→"model".
Optimizer state inherits the param specs verbatim.

A spec is a tuple with one entry per tensor dim, as ``tuple()`` of the
reference's ``PartitionSpec``: None, an axis name, or a tuple of axes (a
one-axis tuple is its name, as ``PartitionSpec`` normalises it). Paths are
the reference's ``"layers/attn/wq"`` strings, and trees are walked in
sorted key order, as ``jax.tree_util`` flattens a dict, so
``PolicyReport``'s lists come in the reference's order.
``to_placements(spec, mesh)`` gives the DTensor placements of a spec, and
``local_shape`` the shard a device holds.

Every fallback is recorded in ``PolicyReport`` and surfaced by the dry run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import abstract_mesh, batch_axes


@dataclass
class PolicyReport:
    sharded: List[str] = field(default_factory=list)
    replicated: List[str] = field(default_factory=list)
    fallbacks: List[str] = field(default_factory=list)


def P(*entries) -> Tuple:
    """A spec: one entry per dim, a one-axis tuple written as its name."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def tree_map_with_path(fn: Callable, tree, *rest, path: Tuple = ()):
    """``fn(path, leaf, *matching)`` over a dict tree (sorted keys) or a
    named tuple of trees; leaves are anything with a ``shape``. ``rest``
    are trees of the same structure, their leaves passed as they are
    (specs are tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, getattr(tree, f),
                               *(getattr(r, f) for r in rest),
                               path=path + (f,))
            for f in tree._fields))
    return fn(path, tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def param_specs(cfg: ModelConfig, params_tree: Any, mesh,
                fsdp: bool = False) -> Tuple[Any, PolicyReport]:
    """Spec tree for a params tree (meta or real tensors).

    ``fsdp=True`` additionally shards one more (divisible, yet-unsharded)
    dimension of each >=2D weight over the "data" axis — ZeRO-3-style fully
    sharded parameters/optimizer state for training and for serving models
    whose TP-sharded weights exceed a single device's memory (qwen3-moe).
    """
    shape_of = abstract_mesh(mesh).shape
    msize = shape_of["model"]
    dsize = shape_of.get("data", 1)
    report = PolicyReport()
    heads_ok = cfg.num_heads > 0 and cfg.num_heads % msize == 0
    kv_ok = cfg.num_kv_heads > 0 and cfg.num_kv_heads % msize == 0
    ff_ok = cfg.d_ff > 0 and cfg.d_ff % msize == 0
    experts_ok = cfg.num_experts > 0 and cfg.num_experts % msize == 0
    vocab_ok = cfg.padded_vocab % msize == 0 if cfg.vocab_size else False

    def rule(path, leaf) -> Tuple:
        name = _path_str(path)
        ndim = len(leaf.shape)
        stacked = name.startswith("layers/") or name.startswith("enc_layers/")
        lead = (None,) if stacked else ()

        def spec(*rest):
            return P(*(lead + rest))

        # ---- embeddings ----
        if name.endswith("embed/table"):
            return P("model", None) if vocab_ok else P(None, None)
        if name.endswith("embed/unembed"):
            return P(None, "model") if vocab_ok else P(None, None)
        # ---- attention ----
        if "/attn/" in name or "/xattn/" in name:
            w = name.split("/")[-1]
            if w == "wq" and heads_ok:
                return spec(None, "model")
            if w in ("wk", "wv") and kv_ok:
                return spec(None, "model")
            if w == "wo" and heads_ok:
                return spec("model", None)
            report.fallbacks.append(f"{name}: heads {cfg.num_heads}/kv "
                                    f"{cfg.num_kv_heads} !% model({msize}) -> replicated")
            return spec(*([None] * (ndim - len(lead))))
        # ---- MoE experts ----
        if "/ffn/" in name and cfg.is_moe:
            w = name.split("/")[-1]
            if w == "router":
                return spec(None, None)
            if experts_ok:
                return spec("model", None, None)           # expert-parallel
            if ff_ok:
                report.fallbacks.append(
                    f"{name}: E={cfg.num_experts} !% model({msize}) -> "
                    "d_ff-sharded instead of expert-parallel")
                if w in ("wi", "wg"):
                    return spec(None, None, "model")       # d_ff fallback
                if w == "wo":
                    return spec(None, "model", None)
            report.fallbacks.append(f"{name}: E={cfg.num_experts} and "
                                    f"d_ff={cfg.d_ff} !% model -> replicated")
            return spec(*([None] * (ndim - len(lead))))
        # ---- dense FFN ----
        if "/ffn/" in name:
            w = name.split("/")[-1]
            if ff_ok:
                if w in ("wi", "wg"):
                    return spec(None, "model")
                if w == "wo":
                    return spec("model", None)
            report.fallbacks.append(f"{name}: d_ff={cfg.d_ff} !% model -> replicated")
            return spec(*([None] * (ndim - len(lead))))
        # ---- everything else (norms, ssm mixer, projections, scalars) ----
        return spec(*([None] * max(ndim - len(lead), 0)))

    def with_fsdp(path, leaf, sp):
        name = _path_str(path)
        axes = list(sp) + [None] * (len(leaf.shape) - len(sp))
        if not fsdp or len(leaf.shape) < 2:
            return P(*axes)
        stacked = name.startswith("layers/") or name.startswith("enc_layers/")
        # candidate dims: skip the stacked layer dim; prefer the largest
        cands = [(leaf.shape[i], i) for i in range(len(axes))
                 if axes[i] is None and not (stacked and i == 0)
                 and leaf.shape[i] % dsize == 0 and leaf.shape[i] >= dsize]
        if cands:
            _, i = max(cands)
            axes[i] = "data"
        return P(*axes)

    base = tree_map_with_path(rule, params_tree)
    specs = tree_map_with_path(with_fsdp, params_tree, base)

    def log(path, leaf, sp):
        name = _path_str(path)
        if any(ax is not None for ax in sp):
            report.sharded.append(f"{name}: {_spec_repr(sp)}")
        else:
            report.replicated.append(name)
    tree_map_with_path(log, params_tree, specs)
    return specs, report


def _spec_repr(sp: Tuple) -> str:
    """The reference's ``PartitionSpec`` repr (its ``sharded`` strings)."""
    return "PartitionSpec(" + ", ".join(repr(a) for a in sp) + ")"


def cache_specs(cfg: ModelConfig, cache_tree: Any, mesh, global_batch: int) -> Any:
    """Specs for a decode cache tree."""
    shape_of = abstract_mesh(mesh).shape
    baxes = batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= shape_of[a]
    bspec = P(*baxes) if global_batch % bsize == 0 and global_batch >= bsize else P()
    b = bspec if bspec != P() else None
    bats = baxes if b is not None else None
    msize = shape_of["model"]

    def rule(path, leaf):
        name = _path_str(path)
        shape = leaf.shape
        if name == "pos":
            return P(bats) if bats else P()
        if name in ("k", "v"):
            # (L, B, KV, C, hd): batch -> data axes, cache seq -> model
            c_ok = shape[3] % msize == 0
            return P(None, bats, None, "model" if c_ok else None, None)
        if name == "conv":
            return P(None, bats, None, None)
        if name == "ssd":
            return P(None, bats, None, None, None)
        if name == "enc":
            return P(bats, None, None)
        return P(*([None] * len(shape)))

    return tree_map_with_path(rule, cache_tree)


def batch_specs(cfg: ModelConfig, batch_tree: Any, mesh, global_batch: int) -> Any:
    shape_of = abstract_mesh(mesh).shape
    baxes = batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= shape_of[a]
    bats = baxes if (global_batch % bsize == 0 and global_batch >= bsize) else None

    def rule(path, leaf):
        nd = len(leaf.shape)
        return P(bats, *([None] * (nd - 1))) if nd else P()

    return tree_map_with_path(rule, batch_tree)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Tuple, mesh) -> Tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim: a
    mesh axis that shards tensor dim d is ``Shard(d)`` (several axes on
    one dim are several ``Shard(d)``), any other ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = abstract_mesh(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in _axes_of(entry):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Tuple, mesh) -> Tuple[int, ...]:
    """The shard of a ``shape`` tensor under ``spec`` that the first device
    holds: each sharded dim split by its axes' sizes in turn, rounding up
    (``torch.chunk``'s first piece, as DTensor's ``Shard`` cuts)."""
    sizes = abstract_mesh(mesh).shape
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in _axes_of(entry):
            out[d] = -(-out[d] // sizes[ax])
    return tuple(out)

"""Adam/AdamW with warmup + cosine or constant schedules and global-norm
clipping: the port of ``repro.train.optimizer`` (no ``torch.optim``).

The state is a params-shaped tree (``AdamState``: ``step``, ``mu``,
``nu``), the same tree the checkpoint saves under the reference's keys.
The arithmetic is the reference's, in fp32 and in its order: the clip by
the pre-clip norm (reported as ``grad_norm``), ``step + 1`` before the
schedule, the bias corrections ``1 - b**step`` in fp32, weight decay added
to the update and ``(p.float() - lr * u).to(p.dtype)``. Each leaf is
updated in turn, so only one leaf's temporaries exist at a time.

Trees are nested dicts, NamedTuples, lists and tuples of tensors; the
helpers below walk them (dict keys in sorted order, as JAX's flattening).
``value_and_grad`` is ``jax.value_and_grad(fn, has_aux=True)`` on such a
tree, through ``torch.autograd``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped as ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            built = {k: walk(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def value_and_grad(fn: Callable, params, *args) -> Tuple[Tuple[Any, Dict],
                                                         Any]:
    """``((value, aux), grads)`` of ``value, aux = fn(params, *args)``: the
    gradient of the scalar ``value`` with respect to every floating leaf of
    ``params``, a tree of the same structure (zeros where a leaf does not
    reach the value). ``fn`` runs on detached copies of the leaves that
    require grad, so the caller's tensors are left as they were; the value
    and ``aux`` come back detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(p.is_floating_point())
            for p in leaves]
    with torch.enable_grad():
        value, aux = fn(tree_unflatten(params, live), *args)
        wrt = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(value, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return ((value.detach(), tree_map(torch.Tensor.detach, aux)),
            tree_unflatten(params, grads))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor        # int32, 0-d
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"   # "cosine" | "constant"


def _schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def adam_init(params) -> AdamState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=zeros, nu=tree_map(torch.clone, zeros))


def adam_update(cfg: AdamConfig, grads, state: AdamState, params
                ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One Adam step -> (new params, new state, {"grad_norm", "lr"}); the
    inputs are left as they were."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        # a tensor numerator: ``c / t`` would be ``t.reciprocal() * c``
        scale = torch.clamp(gnorm.new_tensor(cfg.grad_clip) / (gnorm + 1e-9),
                            max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(stepf.new_tensor(b1), stepf)
    bc2 = 1 - torch.pow(stepf.new_tensor(b2), stepf)

    def update(p, g, m, v):
        g = g.float()
        if scale is not None:
            g = g * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    leaves = [update(*xs) for xs in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new_params, mu, nu = (tree_unflatten(params, [x[i] for x in leaves])
                          for i in range(3))
    return new_params, AdamState(step, mu, nu), {"grad_norm": gnorm, "lr": lr}

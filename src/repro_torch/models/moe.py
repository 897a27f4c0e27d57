"""Top-k MoE FFN with sort-based capacity dispatch: the port of
``repro.models.moe``.

Tokens are routed to ``experts_per_token`` experts, grouped per expert into
a capacity-bounded (E, C, D) buffer by a stable sort, run through
per-expert SwiGLU products (batched over E) and combined back
gate-weighted. Overflowing assignments are dropped (capacity-factor
semantics).

Tokens are dispatched in G = ``sharding.context.batch_shard_size()`` groups
of Tg = T / G consecutive tokens, each sorted and capacity-bucketed on its
own with ``moe_capacity(Tg)`` slots an expert (how expert-parallel systems
dispatch per data shard), as the reference does; G is 1 outside an
activation-sharding context, and when G does not divide T. ``constrain``
pins the group dim to the batch axes where the tensors are DTensors and
returns a plain tensor as it is.

Every step is a fixed-shape tensor op with no host sync, so an engine step
that holds an MoE layer can be captured as a CUDA graph:
per-expert counts come from ``scatter_add_`` (not ``bincount``), and
nothing reads a value back to size a tensor.

Both the dispatch scatter and the combine avoid duplicate-index writes
and atomics: ``index_put_`` with repeated indices and ``index_add_`` have
no defined order on CUDA, and the engine's replayed steps are held to the
eager path bitwise.

Three profiler ranges split a layer's device time for
``launch.profile_step``: ``moe.dispatch`` (router, top-k, sort, counts,
the gather into the expert buffer), ``moe.experts`` (the batched
products) and ``moe.combine`` (the gather back and the sum over k). A
replayed graph runs none of them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
# a profiler range of under a microsecond of host time while no profiler
# runs (the public ``record_function`` takes ~10)
from torch._C._profiler import _RecordFunctionFast as _scope

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import truncated_normal_init
from repro_torch.sharding.context import batch_shard_size, constrain


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             param_dtype: torch.dtype, device: torch.device) -> Dict:
    """The reference's draws (router, wi, wg, wo; σ = 1/√shape[0], so the
    (E, ·, ·) expert tensors draw σ = 1/√E). The router is used in fp32
    and stays in the param dtype; the expert matrices are stored in the
    compute dtype, as the port's other matrices are."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": truncated_normal_init(gen, (D, E), 1.0, param_dtype,
                                        device),
        "wi": truncated_normal_init(gen, (E, D, F_), 1.0, dtype, device),
        "wg": truncated_normal_init(gen, (E, D, F_), 1.0, dtype, device),
        "wo": truncated_normal_init(gen, (E, F_, D), 1.0, dtype, device),
    }


def moe_capacity(num_tokens: int, cfg: ModelConfig,
                 capacity_factor: float) -> int:
    """Slots per expert: ``T·k·cf / E + 1``, rounded up to a multiple of 8
    and at least 8 (the reference's rule)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = int(num_tokens * k * capacity_factor / E) + 1
    return max(8, ((cap + 7) // 8) * 8)


def route(cfg: ModelConfig, p: Dict, flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat (T, D) -> (probs (T, E) fp32, renormalised gates (T, k) fp32,
    expert ids (T, k)). Logits in fp32 from the fp32 router. Among equal
    probabilities ``jax.lax.top_k`` returns the lower expert id first, which
    a stable descending sort reproduces (``torch.topk`` promises no order
    of ties)."""
    logits = flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, ids = vals[:, :k], idx[:, :k]
    return probs, gates / gates.sum(dim=-1, keepdim=True), ids


def apply_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              capacity_factor: Optional[float] = None,
              metrics: bool = True) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D) -> (out (B, S, D), metrics: ``aux_loss``,
    ``router_entropy``, ``drop_fraction`` as 0-d fp32 tensors; with
    ``metrics=False`` an empty dict and none of their kernels, as the
    reference's jitted serve steps leave them unused). The capacity is
    ``moe_capacity`` of a dispatch group's tokens (all of this call's B·S
    outside a sharding context), padded rows included, as in the
    reference."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dt, dev = x.dtype, x.device
    T = B * S
    G = batch_shard_size()
    if T % G or G <= 0:
        G = 1
    Tg = T // G
    C = moe_capacity(Tg, cfg, capacity_factor)      # per group
    with _scope("moe.dispatch"):
        flat = x.reshape(T, D)
        if G > 1:
            flat = constrain(flat.view(G, Tg, D), "batch", None,
                             None).reshape(T, D)
        probs, gate_vals, topk_idx = route(cfg, p, flat)
        a = topk_idx.reshape(T * k)                   # expert of each pick
        # group g's picks name (g, e) as g·E + e: one sort buckets them
        ag = (a if G == 1 else
              a + torch.arange(T * k, device=dev) // (Tg * k) * E)
        buf, a_s, pos, keep, order, counts = _dispatch(flat, ag, G * E, C, k)
        if G > 1:
            buf = constrain(buf.view(G, E, C, D), "batch", None, None, None)
    with _scope("moe.experts"):
        # (G, E, C, D) as E batches of G·C rows (a view when G is 1)
        bufe = buf.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
        h = torch.bmm(bufe, p["wi"].to(dt))
        g = torch.bmm(bufe, p["wg"].to(dt))
        out_buf = torch.bmm(F.silu(g) * h, p["wo"].to(dt))
        out_buf = out_buf.view(E, G, C, D).transpose(0, 1)
        if G > 1:
            out_buf = constrain(out_buf, "batch", None, None, None)
        out_buf = out_buf.reshape(G * E * C, D)
    with _scope("moe.combine"):
        # Without atomics: each pick's gate-weighted row, back in
        # token-major order through the inverse permutation, summed over k.
        gate_s = gate_vals.reshape(T * k)[order]
        rows = out_buf[torch.where(keep, a_s * C + pos, 0)]
        rows = torch.where(keep[:, None], rows, 0) * gate_s[:, None].to(dt)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * k, device=dev)
        y = rows[inv].view(T, k, D).sum(dim=1)
        if G > 1:
            y = constrain(y.view(G, Tg, D), "batch", None, None)
        y = y.view(B, S, D)
    if not metrics:
        return y, {}
    # Switch-style load-balance loss over this call's tokens
    fe = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, a, torch.ones(T * k, dtype=torch.float32, device=dev)) / (T * k)
    return y, {
        "aux_loss": E * torch.sum(fe * probs.mean(dim=0)),
        "router_entropy": -torch.mean(torch.sum(
            probs * torch.log(probs + 1e-9), dim=-1)),
        "drop_fraction": 1.0 - torch.mean(keep.float()),
    }


def _dispatch(flat: torch.Tensor, a: torch.Tensor, E: int, C: int, k: int):
    """Group the T·k picks ``a`` (expert ids, token-major) by expert into an
    (E, C, D) buffer of their tokens' rows. Returns (buffer, sorted expert
    ids, slot of each sorted pick, kept mask, the sort's order, picks per
    expert). With G dispatch groups, E counts (group, expert) pairs."""
    dev, dt, D = flat.device, flat.dtype, flat.shape[1]
    # stable sort by expert; slot = rank within the expert's picks
    order = torch.argsort(a, stable=True)
    a_s = a[order]
    src_s = order // k                                # token of each pick
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, a_s, torch.ones_like(a_s))
    starts = torch.cumsum(counts, 0) - counts         # exclusive
    pos = torch.arange(a.numel(), device=dev) - starts[a_s]
    keep = pos < C

    # Dispatch: kept picks land at row a·C + pos of a flat (E·C + 1, D)
    # buffer, each row written once; dropped ones all go to the spare last
    # row, which is sliced off.
    spare = E * C
    row = torch.where(keep, a_s * C + pos, spare)
    buf = torch.zeros(E * C + 1, D, dtype=dt, device=dev)
    buf[row] = flat[src_s]
    buf = buf[:spare].view(E, C, D)
    # The reference (src/repro/models/moe.py:91-93) scatters every dropped
    # pick as a zero row into slot 0 of its expert, and XLA applies those
    # duplicate writes after the kept pick's: slot 0 of every expert with
    # more than C picks reads zero there, and the token that holds that
    # slot gets the expert's output of a zero row (0) while
    # ``drop_fraction`` counts it as kept. The port computes the same
    # result explicitly (ROADMAP §C).
    over = (counts > C)[:, None]
    buf[:, 0] = torch.where(over, torch.zeros((), dtype=dt, device=dev),
                            buf[:, 0])
    return buf, a_s, pos, keep, order, counts


def apply_moe_dense_oracle(cfg: ModelConfig, p: Dict,
                           x: torch.Tensor) -> torch.Tensor:
    """Dropless oracle: every token through every expert, gate-combined.
    O(T·E·D·F): test scale only."""
    B, S, D = x.shape
    dt = x.dtype
    probs, gates, ids = route(cfg, p, x.reshape(B * S, D))
    gate_full = torch.zeros_like(probs).scatter_(1, ids, gates)
    gate_full = gate_full.view(B, S, -1)
    h = torch.einsum("bsd,edf->bsef", x, p["wi"].to(dt))
    g = torch.einsum("bsd,edf->bsef", x, p["wg"].to(dt))
    y = torch.einsum("bsef,efd->bsed", F.silu(g) * h, p["wo"].to(dt))
    return torch.einsum("bsed,bse->bsd", y, gate_full.to(dt))

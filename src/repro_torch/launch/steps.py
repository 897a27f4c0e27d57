"""Step functions: the port of ``repro.launch.steps``'s train, prefill and
serve steps.

  make_train_step(cfg, microbatches) -> train_step(params, opt, batch)
                                        (loss + Adam update at TRAIN_ADAM)
  make_prefill_step(cfg, max_len)    -> prefill_step(params, batch)
  make_serve_step(cfg)               -> serve_step(params, cache, tokens)

The steps are functions of their inputs as in the reference: a train step
returns new params and a new optimizer state and leaves its inputs as they
were. The reference's ``ShapeDtypeStruct`` half (``sds``,
``batch_specs_for``, ``params_shapes``, ``opt_shapes``, ``cache_shapes``,
``input_specs``) serves its multi-pod dry run and is ported with it
(ROADMAP A13).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import (AdamConfig, adam_update, tree_map,
                                         value_and_grad)

TRAIN_ADAM = AdamConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def _slice_mb(x: torch.Tensor, i: int, microbatches: int) -> torch.Tensor:
    mb = x.shape[0] // microbatches
    return x[i * mb:(i + 1) * mb]


def make_train_step(cfg: ModelConfig, microbatches: int = 1) -> Callable:
    """Training step: loss + Adam update. ``microbatches > 1`` accumulates
    fp32 gradients over equal batch slices in order, divides by their
    count and reports the slices' mean loss and mean aux loss, as the
    reference's ``lax.scan`` — a k× smaller activation working set for k×
    weight re-streaming."""
    m = build_model(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(m.loss, params, batch)
        else:
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses, auxes = [], []
            for i in range(microbatches):
                mb_batch = {k: _slice_mb(x, i, microbatches)
                            for k, x in batch.items()}
                (l, met), g = value_and_grad(m.loss, params, mb_batch)
                grads = tree_map(torch.add, grads, g)
                losses.append(l)
                auxes.append(met["aux_loss"])
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = torch.mean(torch.stack(losses))
            metrics = {"ce_loss": loss,
                       "aux_loss": torch.mean(torch.stack(auxes))}
        params, opt_state, opt_metrics = adam_update(TRAIN_ADAM, grads,
                                                     opt_state, params)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    m = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return m.prefill(params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step; the port's ``decode_step`` writes the token's K/V
    (and the SSM states) into ``cache`` in place and returns it."""
    m = build_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return m.decode_step(params, cache, tokens)

    return serve_step

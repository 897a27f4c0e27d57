"""Step functions: the port of ``repro.launch.steps``'s train, prefill and
serve steps.

  make_train_step(cfg, microbatches) -> train_step(params, opt, batch)
                                        (loss + Adam update at TRAIN_ADAM)
  make_prefill_step(cfg, max_len)    -> prefill_step(params, batch)
  make_serve_step(cfg)               -> serve_step(params, cache, tokens)

A batch is a dict of tensors with the batch first: ``tokens`` and
``labels``, and the stub frontends' ``frames`` (encoder-decoder) or
``patch_embeds`` (VLM); every one of them is sliced for the microbatches
and handed to the model, as in the reference.

The steps are functions of their inputs as in the reference: a train step
returns new params and a new optimizer state and leaves its inputs as they
were.

The shape half serves the dry run (``launch.dryrun``), as the reference's
``ShapeDtypeStruct`` half does: ``input_specs(cfg, shape)`` returns the
step the shape's kind runs and its arguments as ``device="meta"`` tensors
(shapes and dtypes, nothing allocated):
  train_4k     -> train_step(params, opt, batch)  (loss + Adam update, remat)
  prefill_32k  -> prefill_step(params, batch)     (prompt -> cache + logits)
  decode_*     -> serve_step(params, cache, toks) (ONE token, KV/state cache)
Params hold every leaf in the config's param dtype, as the reference's
init does. Audio/VLM frontends are stubs: the batch carries precomputed
frame/patch embeddings of the right shape. One difference: the cache's
``pos`` is int64 (the port's engine advances it on the device), int32 in
the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.device import torch_dtype
from repro_torch.models.model import (AUDIO_FRAME_DIM, VISION_EMBED_DIM,
                                      build_model)
from repro_torch.train.optimizer import (AdamConfig, adam_init, adam_update,
                                         tree_map, value_and_grad)

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


# ---------------------------------------------------------------------------
# shapes: meta tensors for the dry run
# ---------------------------------------------------------------------------

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a torch dtype or a config
    dtype name): the port of ``jax.ShapeDtypeStruct``."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B = shape.global_batch
    S = shape.seq_len
    batch: Dict[str, Any] = {}
    if shape.kind == "train":
        batch["tokens"] = sds((B, S), torch.int32)
        batch["labels"] = sds((B, S), torch.int32)
    elif shape.kind == "prefill":
        batch["tokens"] = sds((B, S), torch.int32)
    if cfg.is_encoder_decoder and shape.kind in ("train", "prefill"):
        batch["frames"] = sds((B, cfg.enc_seq, AUDIO_FRAME_DIM), cfg.dtype)
    if cfg.frontend == "vision_patches" and shape.kind in ("train", "prefill"):
        batch["patch_embeds"] = sds((B, cfg.num_frontend_tokens,
                                     VISION_EMBED_DIM), cfg.dtype)
    return batch


def params_shapes(cfg: ModelConfig):
    """The params tree on meta, every leaf in the param dtype."""
    return build_model(cfg).init(torch.Generator(),
                                 dtype=torch_dtype(cfg.param_dtype),
                                 device=META)


def opt_shapes(params):
    return adam_init(params)


def cache_shapes(cfg: ModelConfig, shape: InputShape):
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       META)


def input_specs(cfg: ModelConfig, shape: InputShape,
                microbatches: int = 1) -> Tuple[Callable, Tuple]:
    """Returns (step_fn, its arguments as meta tensors)."""
    params = params_shapes(cfg)
    if shape.kind == "train":
        fn = make_train_step(cfg, microbatches=microbatches)
        return fn, (params, opt_shapes(params), batch_specs_for(cfg, shape))
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, max_len=shape.seq_len)
        return fn, (params, batch_specs_for(cfg, shape))
    # decode
    fn = make_serve_step(cfg)
    cache = cache_shapes(cfg, shape)
    toks = sds((shape.global_batch,), torch.int32)
    return fn, (params, cache, toks)

"""Language model, dense family: the port of ``repro.models.model.LM``.

Parameters are a plain dict with the reference's pytree keys and stacked
layer leaves (``layers.attn.wq`` is ``(L, D, H·hd)``), so the weight bridge
maps leaves one to one; layers run in a Python loop over those stacks.

Caches are updated **in place**: ``decode_step`` writes the new token's K/V
into the cache tensors it is given and advances ``cache["pos"]``, where the
reference rebuilds its cache functionally and donates the old buffers.

Public methods:
  init(gen)                               -> params
  apply(params, batch)                    -> (logits, aux) (teacher forcing)
  init_cache(batch_size, max_len, device) -> cache dict
  prefill(params, batch, max_len)         -> (last-token logits, cache)
  decode_step(params, cache, tokens)      -> (logits, cache)

Other families (MoE, SSM/hybrid, encoder-decoder, VLM), the paged cache and
chunked prefill are not ported yet.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, embed, init_embed, init_mlp,
                                       rms_norm, unembed, vocab_mask)


def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    w = np.full((cfg.num_layers,), cfg.sliding_window, np.int32)
    if cfg.sliding_window and cfg.global_layer_every:
        w[::cfg.global_layer_every] = 0
    return w


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_layers(dicts: List[Dict]) -> Dict:
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack_layers([d[k] for d in dicts]) for k in first}
    return torch.stack(dicts)


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.is_encoder_decoder or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name!r}: only the dense family is ported (ROADMAP A8, "
                f"A9 queue MoE, SSM/hybrid, encoder-decoder and VLM)")
        if cfg.rope_theta <= 0:
            raise NotImplementedError(
                f"{cfg.name!r}: sinusoidal positions are not ported")
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.dtype)
        self.param_dtype = torch_dtype(cfg.param_dtype)
        self._vmask_np = vocab_mask(cfg)
        self._vmask: Dict = {}
        self._windows = [int(w) for w in _layer_windows(cfg)]
        self._layers_of = None       # (stacked layers dict, per-layer views)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator, device) -> Dict:
        cfg = self.cfg
        wdt = self.compute_dtype
        return {"ln1": torch.zeros(cfg.d_model, dtype=self.param_dtype,
                                   device=device),
                "attn": attn.init_attention(gen, cfg, wdt, device),
                "ffn": init_mlp(gen, cfg, wdt, device),
                "ln2": torch.zeros(cfg.d_model, dtype=self.param_dtype,
                                   device=device)}

    def init(self, gen: torch.Generator) -> Dict:
        """Params on ``gen.device`` drawn from ``gen``: the reference's
        distributions (truncated normal, σ = 1/√fan_in; zero norms). Matrices
        are stored in the compute dtype — the reference casts its fp32
        params to it before every product, so the products are the same —
        and norm weights in the param dtype."""
        cfg = self.cfg
        dev = gen.device
        params: Dict = {
            "embed": init_embed(gen, cfg, self.compute_dtype, dev),
            "final_norm": torch.zeros(cfg.d_model, dtype=self.param_dtype,
                                      device=dev)}
        params["layers"] = _stack_layers(
            [self._init_layer(gen, dev) for _ in range(cfg.num_layers)])
        return params

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _layers(self, params: Dict) -> List[Dict]:
        """Per-layer views of the stacked leaves, cached for the last params
        seen (the hot decode loop would otherwise re-slice every step)."""
        stacked = params["layers"]
        if self._layers_of is None or self._layers_of[0] is not stacked:
            self._layers_of = (stacked, [_layer_slice(stacked, i)
                                         for i in range(self.cfg.num_layers)])
        return self._layers_of[1]

    def _logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(cfg, params["embed"], x)
        key = (logits.device, logits.dtype)
        if key not in self._vmask:
            self._vmask[key] = torch.as_tensor(self._vmask_np).to(
                device=logits.device, dtype=logits.dtype)
        return logits + self._vmask[key]

    def _ffn(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return x + apply_mlp(cfg, lp["ffn"], rms_norm(x, lp["ln2"],
                                                      cfg.norm_eps))

    # ------------------------------------------------------------------
    # full-sequence forward (teacher forcing)
    # ------------------------------------------------------------------
    def apply(self, params: Dict, batch: Dict, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(cfg, params["embed"], tokens, self.compute_dtype)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for lp, w in zip(self._layers(params), self._windows):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = self._ffn(lp, x + attn.attention_forward(cfg, lp["attn"], h,
                                                         positions, w))
        return self._logits(params, x), torch.zeros((), device=x.device)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_capacity(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window:
            return min(max_len, cfg.sliding_window)
        return max_len

    def init_cache(self, batch_size: int, max_len: int,
                   device: torch.device) -> Dict:
        cfg = self.cfg
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        C = self.cache_capacity(max_len)
        # (L, B, KV, C, hd): the decode kernel's native operand layout
        shape = (L, batch_size, KV, C, hd)
        return {"pos": torch.zeros(batch_size, dtype=torch.int64,
                                   device=device),
                "k": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device)}

    # ------------------------------------------------------------------
    # prefill: run the full prompt, build the cache
    # ------------------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        C = self.cache_capacity(max_len or S)
        cache = self.init_cache(B, max_len or S, dev)
        cache["pos"].fill_(S)
        positions = torch.arange(S, device=dev).expand(B, S)
        if S >= C:
            # keep the last C positions, ring-aligned: slot = pos % C
            slots = (torch.arange(C, device=dev) + (S - C) % C) % C
        x = embed(cfg, params["embed"], tokens, self.compute_dtype)
        for i, (lp, w) in enumerate(zip(self._layers(params), self._windows)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, k, v = attn.attention_forward(cfg, lp["attn"], h, positions, w,
                                             return_kv=True)
            # The reference recomputes K/V from the same normed input for
            # its cache (model.py:609-617); the roped k and v attention just
            # used are the same math, so they are written directly.
            k, v = k.transpose(1, 2), v.transpose(1, 2)        # (B,KV,S,hd)
            if S >= C:
                cache["k"][i][:, :, slots] = k[:, :, S - C:]
                cache["v"][i][:, :, slots] = v[:, :, S - C:]
            else:
                cache["k"][i][:, :, :S] = k
                cache["v"][i][:, :, :S] = v
            x = self._ffn(lp, x + a)
        return self._logits(params, x[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    # one-token decode against the cache
    # ------------------------------------------------------------------
    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) -> (logits (B, V), cache): the token's K/V lands in
        ``cache`` in place and ``cache["pos"]`` advances by one."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed(cfg, params["embed"], tokens[:, None], self.compute_dtype)
        for i, (lp, w) in enumerate(zip(self._layers(params), self._windows)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = attn.decode_attention(cfg, lp["attn"], h, cache["k"][i],
                                            cache["v"][i], pos, w)
            x = self._ffn(lp, x + a)
        pos.add_(1)
        return self._logits(params, x)[:, 0], cache


@functools.lru_cache(maxsize=64)
def _cached_lm(cfg: ModelConfig) -> LM:
    return LM(cfg)


def build_model(cfg: ModelConfig) -> LM:
    return _cached_lm(cfg)

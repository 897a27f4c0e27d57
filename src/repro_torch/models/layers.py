"""Shared neural building blocks: functions on tensors, mirroring
``repro.models.layers`` exactly (norms, RoPE, sinusoidal positions, MLP,
embedding).

Products take operands in the compute dtype; where the reference casts its
fp32 params to the compute dtype before a product (``w.astype(dt)``), the
port does ``w.to(dt)``, a no-op when weights are already stored in it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype: torch.dtype = torch.float32,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """Normal truncated to ±2σ, σ = scale/√fan_in (fan_in = shape[0]),
    drawn in fp32 from ``gen`` and stored in ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + weight`` (zero-initialised weights)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Mean-centred norm in fp32, scaled by ``weight`` plus ``bias``."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S). Half-split (not interleaved)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    angles = positions[..., None].float() * freqs               # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) fp32 table: sin at even columns, cos at odd, of
    pos / 10000^(2i / d_model), the angles in float64 (numpy)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    out = np.zeros((max_len, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device, d_ff: Optional[int] = None) -> Dict:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": truncated_normal_init(gen, (D, F_), 1.0, dtype, device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["wg"] = truncated_normal_init(gen, (D, F_), 1.0, dtype, device)
    p["wo"] = truncated_normal_init(gen, (F_, D), 1.0, dtype, device)
    return p


def apply_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if cfg.mlp_type == "swiglu":
        g = x @ p["wg"].to(dt)
        h = F.silu(g) * h
    elif cfg.mlp_type == "geglu":
        g = x @ p["wg"].to(dt)
        h = F.gelu(g, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding with vocab padding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Dict:
    p = {"table": truncated_normal_init(gen, (cfg.padded_vocab, cfg.d_model),
                                        1.0, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), 1.0, dtype, device)
    return p


def embed(cfg: ModelConfig, p: Dict, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    x = F.embedding(tokens, p["table"]).to(dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    return x


def unembed(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["table"].to(x.dtype).t()
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def vocab_mask(cfg: ModelConfig) -> np.ndarray:
    """Additive mask: 0 for real vocab entries, -1e9 for padding."""
    m = np.zeros((cfg.padded_vocab,), np.float32)
    m[cfg.vocab_size:] = -1e9
    return m

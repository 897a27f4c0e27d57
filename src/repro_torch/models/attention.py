"""GQA attention, dense part: full-sequence causal attention (prefill) and
one-token decode against the dense per-slot ring cache — the port of the
dense functions of ``repro.models.attention``.

Two execution paths, as in the reference:
  * plain PyTorch (``gqa_attend``; the oracle path);
  * the CUDA kernels (``cfg.use_kernels``) via ``repro_torch.kernels.ops``.

The reference's ``flash_attend_qblocks`` (its jnp path above 2048 tokens,
which bounds memory by attending in query blocks) is not ported yet: the
plain path here attends over the full (S, S) score matrix at any S.
Paged-KV attention (``PagedKVCache``, ``paged_decode_attention``) and
chunk-prefill attention are not ported yet either.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, truncated_normal_init


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                   device: torch.device) -> Dict:
    D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": truncated_normal_init(gen, (D, H * hd), 1.0, dtype, device),
        "wk": truncated_normal_init(gen, (D, KV * hd), 1.0, dtype, device),
        "wv": truncated_normal_init(gen, (D, KV * hd), 1.0, dtype, device),
        "wo": truncated_normal_init(gen, (H * hd, D), 1.0, dtype, device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def causal_mask_bias(q_len: int, kv_len: int, q_offset: int, window: int,
                     device=None) -> torch.Tensor:
    """(q_len, kv_len) additive fp32 bias; window == 0 means full causal."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    ok = kj <= qi
    if window > 0:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, -1e9).to(torch.float32)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], softcap: float = 0.0
               ) -> torch.Tensor:
    """q: (B,S,H,hd)  k,v: (B,T,KV,hd)  bias: (S,T) or (B,S,T) additive.

    Scores and softmax in fp32; probabilities are cast back to the value
    dtype for the PV product with fp32 accumulation (the reference's
    ``preferred_element_type=float32`` convention)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if bias is not None:
        if bias.dim() == 2:
            scores = scores + bias[None, None, None, :, :]
        else:
            scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def qkv_project(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> roped q (B,S,H,hd), roped k (B,S,KV,hd), v (B,S,KV,hd)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = _split_heads(x @ p["wq"].to(dt), H, hd)
    k = _split_heads(x @ p["wk"].to(dt), KV, hd)
    v = _split_heads(x @ p["wv"].to(dt), KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, window: Optional[int] = None,
                      return_kv: bool = False):
    """Full-sequence causal self-attention (prefill). With ``return_kv``
    also returns the roped k and v (B,S,KV,hd) it attended over, which
    ``LM.prefill`` writes into the cache."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    q, k, v = qkv_project(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    S = x.shape[1]
    if cfg.use_kernels:
        out = kops.flash_prefill(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=int(w),
                                 softcap=cfg.attn_logit_softcap)
    else:
        bias = causal_mask_bias(S, S, 0, int(w), x.device)
        out = gqa_attend(q, k, v, bias, cfg.attn_logit_softcap)
    out = out.reshape(x.shape[0], S, H * hd) @ p["wo"].to(dt)
    return (out, k, v) if return_kv else out


def decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, 1, D); k/v_cache: (B, KV, C, hd) with C = cache capacity.

    ``pos``: (B,) absolute position of the new token. The cache is a ring
    indexed by ``pos % C``. The new token's K/V is written into the cache
    **in place** (the reference rebuilds its cache functionally) before
    attending, so the token attends to itself.

    Returns (attn_out (B,1,D), k_cache, v_cache) — the same cache tensors.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    B, C = k_cache.shape[0], k_cache.shape[2]
    q, k, v = qkv_project(cfg, p, x, pos[:, None])

    slot = pos % C                                            # (B,)
    batch_idx = torch.arange(B, device=x.device)
    k_cache[batch_idx, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[batch_idx, :, slot] = v[:, 0].to(v_cache.dtype)

    w = cfg.sliding_window if window is None else window
    # validity of each cache slot: the absolute position stored in slot j is
    # the largest value p <= pos with p % C == j; valid iff pos - p < min(C, pos+1)
    j = torch.arange(C, device=x.device)[None, :]
    stored_pos = pos[:, None] - ((pos[:, None] - j) % C)     # (B, C)
    ok = stored_pos >= 0
    ok &= stored_pos >= torch.clamp(pos[:, None] - C + 1, min=0)
    if w:
        ok &= stored_pos > pos[:, None] - w
    bias = torch.where(ok, 0.0, -1e9).to(torch.float32)     # (B, C)

    qg = q.reshape(B, KV, H // KV, hd)                       # (B,KV,G,hd)
    if cfg.use_kernels:
        out = kops.flash_decode_bkchd(qg.contiguous(), k_cache, v_cache, bias,
                                      softcap=cfg.attn_logit_softcap)
    else:
        scores = torch.einsum("bkgh,bkth->bkgt", qg.float(),
                              k_cache.float()) / math.sqrt(hd)
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = torch.tanh(scores / c) * c
        scores = scores + bias[:, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,bkth->bkgh", probs.to(v_cache.dtype).float(),
                           v_cache.float()).to(dt)
    out = out.reshape(B, 1, H * hd)
    return out @ p["wo"].to(dt), k_cache, v_cache

"""A decoder-only transformer in plain PyTorch, float32 with TF32 off.

It follows the published descriptions the configurations cite: token
embedding; per layer an RMS-normed pre-attention block (grouped-query
causal attention with rotary positions, the two halves of each head
rotated) and an RMS-normed pre-FFN block (a SwiGLU MLP, or for a
sparse-expert model a softmax router over all experts whose top ``k``
gates are renormalised and whose chosen experts' SwiGLU outputs are summed
with those gates); a final RMS norm and the unembedding over the real
vocabulary. Departures, as the program runs the model: a norm gain is
stored as ``g - 1``. The router is dropless: every token reaches its k
experts, as the published routers of the configurations do; the harness
refuses a configuration whose expert capacity could drop a token.

``quant="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 (weights per output column, activations per row,
each scaled to the format's range) and accumulates in float32; the router,
norms, softmax and attention scores stay in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

FP8_MAX = 448.0


def set_precision() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32."""
    w = w.float()
    if quant == "fp8":
        x = _q8(x, -1)
        w = _q8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, g_minus_1: torch.Tensor, eps: float
         ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + g_minus_1.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, S, n, hd): rotate each head's two halves by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(m: Dict, p: Dict, i: int, h: torch.Tensor,
               quant: Optional[str]) -> torch.Tensor:
    R, S, _ = h.shape
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = _mm(h, p["wq"][i], quant).view(R, S, H, hd)
    k = _mm(h, p["wk"][i], quant).view(R, S, KV, hd)
    v = _mm(h, p["wv"][i], quant).view(R, S, KV, hd)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    # query head j reads key/value head j // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(R, S, H, hd, dtype=torch.float32, device=h.device)
    for r in range(R):            # one row at a time keeps (H, S, S) small
        s = torch.einsum("shd,thd->hst", q[r], k[r]) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[r] = torch.einsum("hst,thd->shd", s, v[r])
    return _mm(out.reshape(R, S, H * hd), p["wo"][i], quant)


def _swiglu(x: torch.Tensor, wi, wg, wo, quant) -> torch.Tensor:
    return _mm(torch.nn.functional.silu(_mm(x, wg, quant))
               * _mm(x, wi, quant), wo, quant)


def _experts(m: Dict, p: Dict, i: int, h: torch.Tensor,
             quant: Optional[str]) -> torch.Tensor:
    R, S, D = h.shape
    E, k = m["num_experts"], m["experts_per_token"]
    x = h.reshape(R * S, D)
    probs = (x @ p["router"][i].float()).softmax(-1)
    # the top k, ties to the lower expert id
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    ids = ids[:, :k]
    y = torch.zeros_like(x)
    for e in range(E):
        chose = ids == e                               # (T, k)
        toks = chose.any(-1).nonzero()[:, 0]           # in token order
        if len(toks) == 0:
            continue
        gate = (gates * chose).sum(-1)[toks]
        out = _swiglu(x[toks], p["wi"][i][e], p["wg"][i][e],
                      p["wo"][i][e], quant)
        y.index_add_(0, toks, gate[:, None] * out)
    return y.view(R, S, D)


def hidden(m: Dict, params: Dict, tokens: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """tokens (R, S) -> the final hidden states (R, S, D), normed, float32.
    ``m`` is a configuration file's ``model`` group."""
    lay = params["layers"]
    eps = m["norm_eps"]
    x = params["embed"]["table"][tokens].float()
    for i in range(m["num_layers"]):
        x = x + _attention(m, lay["attn"], i, _rms(x, lay["ln1"][i], eps),
                           quant)
        h = _rms(x, lay["ln2"][i], eps)
        f = lay["ffn"]
        if m.get("num_experts", 0):
            x = x + _experts(m, f, i, h, quant)
        else:
            x = x + _swiglu(h, f["wi"][i], f["wg"][i], f["wo"][i], quant)
    return _rms(x, params["final_norm"], eps)


def logits(m: Dict, params: Dict, h: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Normed hidden states (N, D) -> logits over the real vocabulary
    (N, vocab_size), float32."""
    return _mm(h, params["embed"]["unembed"][:, :m["vocab_size"]], quant)

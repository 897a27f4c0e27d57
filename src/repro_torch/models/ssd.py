"""Mamba-2 SSD (state-space duality) mixer: the port of ``repro.models.ssd``.

``ssd_chunked`` is the chunked scan in plain PyTorch and the plain version
of the CUDA kernel ``kernels/csrc/ssd_scan.cu``: intra-chunk outputs are a
masked-decay (q×q) product, inter-chunk states follow the linear
recurrence (arXiv:2405.21060). ``ssm_forward`` runs the full mixer
(in_proj → causal conv → SSD → gated norm → out_proj) and routes the scan
through the kernel when ``cfg.use_kernels``; ``ssm_decode`` is the
one-token recurrence, plain tensor code on both paths as in the reference.

Parameter dtypes follow the port's storage rule (``bridge``): the two
projections are stored in the compute dtype, every other SSM leaf in the
param dtype, because the reference uses ``conv_w``/``conv_b``, ``A_log``,
``dt_bias`` and ``norm_w`` in fp32 whatever the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm, truncated_normal_init


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[..., i, j] = sum_{k=j+1..i} x_k
    (j <= i), -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  (b, s, h, p)   per-head inputs
    dt: (b, s, h)      discretization steps (post-softplus)
    A:  (h,)           negative decay rates
    B:  (b, s, n)      input projections (ngroups=1, shared across heads)
    C:  (b, s, n)      output projections
    Returns y (b, s, h, p) in x's dtype and the final state (b, h, p, n)
    in fp32. ``s % chunk == 0``.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    c, q = s // chunk, chunk

    xdt = x.float() * dt.float()[..., None]                 # dt-weighted input
    dA = dt.float() * A.float()                             # (b, s, h)

    xdt = xdt.reshape(b, c, q, h, p)
    Bc = B.reshape(b, c, q, n).float()
    Cc = C.reshape(b, c, q, n).float()
    dA = dA.reshape(b, c, q, h).permute(0, 3, 1, 2)         # (b, h, c, q)
    dA_cs = torch.cumsum(dA, dim=-1)                        # (b, h, c, q)

    # 1) intra-chunk (dense quadratic block)
    L = torch.exp(segsum(dA))                               # (b, h, c, q, q)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xdt)

    # 2) per-chunk end states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)       # (b, h, c, q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xdt)

    # 3) inter-chunk recurrence over the chunk dimension
    chunk_decay = torch.exp(dA_cs[..., -1])                 # (b, h, c)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for i in range(c):
        prev.append(state)                          # the state BEFORE chunk i
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                  # (b, c, h, p, n)

    # 4) contribution of the carried-in state to each position
    state_decay_out = torch.exp(dA_cs)                      # (b, h, c, q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay_out)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. x: (b,h,p), dt: (b,h), B,C: (b,n),
    state: (b,h,p,n) fp32 -> (y (b,h,p) in x's dtype, new state)."""
    dA = torch.exp(dt.float() * A.float())                  # (b, h)
    dBx = torch.einsum("bn,bhp->bhpn", B.float(),
                       x.float() * dt.float()[..., None])
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv (width cw) over the (x, B, C) channels, as in Mamba-2
# ---------------------------------------------------------------------------

def causal_conv1d(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                  ) -> torch.Tensor:
    """u: (b, s, ch); w: (cw, ch); bias: (ch,). Causal depthwise conv + silu,
    fp32 inside, taps summed in the reference's order."""
    cw, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(cw):   # cw is tiny (4): unrolled taps
        out = out + pad[:, i:i + S, :].float() * w[i].float()
    return F.silu(out + bias.float()).to(u.dtype)


def conv_decode_step(u_t: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_t: (b, ch); conv_state: (b, cw-1, ch) past inputs.
    Returns (out (b, ch), new state (b, cw-1, ch))."""
    window = torch.cat([conv_state, u_t[:, None, :]], dim=1)   # (b, cw, ch)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    out = F.silu(out + bias.float()).to(u_t.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Full SSM mixer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             param_dtype: torch.dtype, device: torch.device) -> Dict:
    """The reference's distributions; projections in ``dtype`` (the
    compute dtype), the rest in ``param_dtype``."""
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    pd = param_dtype
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=gen,
                         device=device) * 0.1
    return {
        "in_proj": truncated_normal_init(gen, (D, 2 * di + 2 * N + H), 1.0,
                                         dtype, device),
        "conv_w": conv_w.to(pd),
        "conv_b": torch.zeros(conv_ch, dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(pd),
        "D_skip": torch.ones(H, dtype=pd, device=device),
        "dt_bias": torch.zeros(H, dtype=pd, device=device),
        "norm_w": torch.zeros(di, dtype=pd, device=device),
        "out_proj": truncated_normal_init(gen, (di, D), 1.0, dtype, device),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """z (di) | x,B,C (di + 2N, through the conv) | dt (H)."""
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xc, dt


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) of a (b, s, ...) tensor by ``pad``."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked`` at any s: the sequence is zero-padded to a chunk
    multiple and y sliced back, as ``ssm_forward`` does in the reference.
    Padded steps have dt = 0, so they leave the state unchanged."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
    y, state = ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    return (y[:, :S] if pad else y), state


def ssm_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None,
                return_cache: bool = False):
    """Full-sequence SSM mixer. x: (B,S,D) -> (B,S,D)
    [+ (conv_state (B,cw-1,di+2N), ssd_state (B,H,hp,N) fp32)]."""
    B_, S, _ = x.shape
    di, N, H, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xc_raw, dtr = _split_in_proj(cfg, zxbcdt)
    xc = causal_conv1d(xc_raw, p["conv_w"], p["conv_b"])
    # views of the conv output: the kernel reads them through their strides
    xs = xc[..., :di].unflatten(-1, (H, hp))
    Bm = xc[..., di:di + N]
    Cm = xc[..., di + N:]
    dt = F.softplus(dtr.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    chunk = min(cfg.ssd_chunk, S)
    if cfg.use_kernels:
        # the kernel masks a ragged last chunk itself: no padding copies
        from repro_torch.kernels import ops as kops
        y, ssd_state = kops.ssd_scan(xs, dt, A, Bm, Cm, chunk=chunk,
                                     initial_state=initial_state)
    else:
        y, ssd_state = ssd_scan_plain(xs, dt, A, Bm, Cm, chunk, initial_state)
    y = y + xs * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z.float()).to(dt_), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if return_cache:
        # conv state: the last (cw-1) *pre-conv* channel inputs
        cw = cfg.conv_width
        if S >= cw - 1:
            conv_state = xc_raw[:, S - (cw - 1):S, :]
        else:
            conv_state = F.pad(xc_raw, (0, 0, cw - 1 - S, 0))
        return out, (conv_state, ssd_state)
    return out


def ssm_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """One-token SSM step. x: (B,1,D). Returns (out (B,1,D), conv_state,
    ssd_state), the states new tensors (the caller writes them back)."""
    B_ = x.shape[0]
    di, N, H, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)
    z, xc_raw, dtr = _split_in_proj(cfg, zxbcdt)
    xc, conv_state = conv_decode_step(xc_raw, conv_state, p["conv_w"],
                                      p["conv_b"])
    xs = xc[..., :di].reshape(B_, H, hp)
    Bm = xc[..., di:di + N]
    Cm = xc[..., di + N:]
    dt = F.softplus(dtr.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, ssd_state = ssd_decode_step(xs, dt, A, Bm, Cm, ssd_state)
    y = y + xs * p["D_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(B_, di)
    y = rms_norm(y * F.silu(z.float()).to(dt_), p["norm_w"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, conv_state, ssd_state

"""Language model, every family of the reference (dense, MoE, SSM,
hybrid, VLM, encoder-decoder): the port of ``repro.models.model.LM``.

Parameters are a plain dict with the reference's pytree keys and stacked
layer leaves (``layers.attn.wq`` is ``(L, D, H·hd)``), so the weight bridge
maps leaves one to one; layers run in a Python loop over those stacks.

A layer's token mixer is attention (dense, moe), the Mamba-2 SSM
(``ssm``: no attention, no FFN) or both in parallel (``hybrid``: outputs
mixed by ``sigmoid(mix_scale)`` in fp32, then the FFN), as in the
reference's ``_block``. The MoE family's FFN is ``moe.apply_moe`` over
each call's tokens (B·S at prefill and ``apply``, B at a decode step,
B·ck in a chunk), as in the reference.

The VLM family (internvl2-26b) is a dense decoder whose input may start
with ``batch["patch_embeds"]`` (B, P, 1024), stub ViT embeddings projected
by ``vis_proj``: the image prefix comes first and positions run over the
whole sequence; without it the model is text-only, as the engine serves
it. The encoder-decoder family (whisper-tiny) runs ``encode`` over
``batch["frames"]`` (B, T, 80) — ``enc_in``, sinusoidal positions, its own
stack of unmasked attention + MLP layers, ``enc_norm`` — and each decoder
layer adds cross-attention over that output (``xattn`` after ``lnx``)
between its self-attention and its FFN; ``prefill`` keeps the encoder
output in ``cache["enc"]`` for the decode steps, which project its K and
V again at every step, as the reference does. A config with
``rope_theta <= 0`` adds sinusoidal positions to its embeddings: the
full-sequence paths the numpy table ``sinusoidal_positions``, the
per-position paths (decode steps, chunks, the paged step) ``_sinusoid_pe``
computed on the device in fp32, each where the reference uses it.

Caches are updated **in place**: ``decode_step`` writes the new token's K/V
and the SSM's conv/SSD states into the cache tensors it is given and
advances ``cache["pos"]``, where the reference rebuilds its cache
functionally and donates the old buffers. The paged methods do the same to
the page pool, the block table and ``pos``.

Training: ``loss`` is the reference's masked next-token cross-entropy plus
``aux_loss_coef`` times the MoE load-balance loss; under
``apply(train=True)`` with ``cfg.remat`` each layer runs through
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
block), so its activations are recomputed in the backward pass. Gradients
come from ``torch.autograd`` through the plain paths: the CUDA kernels have
no backward (the reference defines none), so training runs with
``use_kernels=False`` and the kernel wrappers refuse autograd on the card.

Public methods:
  init(gen, dtype=None)                   -> params
  apply(params, batch, train=False)       -> (logits, aux) (teacher forcing)
  loss(params, batch)                     -> (scalar, {ce_loss, aux_loss})
  init_cache(batch_size, max_len, device) -> cache dict
  prefill(params, batch, max_len)         -> (last-token logits, cache)
  decode_step(params, cache, tokens)      -> (logits, cache)
  prefill_chunk(params, cache, tokens, start, n_valid)
  init_paged_cache / paged_admit / paged_cow_copy / paged_retire
  prefill_chunk_paged(params, cache, tokens, start, n_valid)
  decode_step_paged(params, cache, tokens, n_pages)
  verify_chunk / verify_chunk_paged(params, cache, tokens, start, n_valid)
                                          -> (greedy argmax (B, ck), cache)

  encode(params, frames)                  -> encoder output (B, T, D)

The paged, chunked and verify forms cover the dense, MoE and VLM families
only (SSM/hybrid state is not positional, the encoder-decoder family adds a
cross cache; the reference refuses them too).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssd
from repro_torch.models.layers import (apply_mlp, embed, init_embed, init_mlp,
                                       rms_norm, sinusoidal_positions,
                                       truncated_normal_init, unembed,
                                       vocab_mask)

AUDIO_FRAME_DIM = 80     # stub frontend: mel-frame embedding width
VISION_EMBED_DIM = 1024  # stub frontend: ViT patch embedding width
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid")


def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    w = np.full((cfg.num_layers,), cfg.sliding_window, np.int32)
    if cfg.sliding_window and cfg.global_layer_every:
        w[::cfg.global_layer_every] = 0
    return w


def _unstack(tree, n: int) -> List:
    """The ``n`` per-layer views of stacked leaves (``unbind``: under
    autograd the layers' gradients come back as one stack, not as ``n``
    full-size scatters)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in per_key} for i in range(n)]
    return tree.unbind(0)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _draw_stacked(n: int, draw) -> Dict:
    """The stacked leaves of ``n`` layers, ``draw()`` called once a layer
    in order and each layer copied into its slice of stacks allocated up
    front: the peak is the stacks plus one layer, where stacking a list of
    drawn layers would hold every layer twice (internvl2-26b's 48 layers
    are 37 GB in bf16)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    layer = draw()
    stacked = alloc(layer)
    for i in range(n):
        put(stacked, layer if i == 0 else draw(), i)
    return stacked


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.dtype)
        self.param_dtype = torch_dtype(cfg.param_dtype)
        self._vmask_np = vocab_mask(cfg)
        self._vmask: Dict = {}
        self._windows = [int(w) for w in _layer_windows(cfg)]
        # stack key ("layers", "enc_layers") -> (stacked dict, its views)
        self._layers_of: Dict[str, Tuple[Dict, List[Dict]]] = {}
        self._pos_tables: Dict = {}  # (S, device, dtype) -> sinusoid rows

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator, device,
                    wdt: torch.dtype) -> Dict:
        cfg = self.cfg
        pd = self.param_dtype
        p = {"ln1": torch.zeros(cfg.d_model, dtype=pd, device=device)}
        if cfg.family in _ATTN_FAMILIES:
            p["attn"] = attn.init_attention(gen, cfg, wdt, device)
        if cfg.family in ("ssm", "hybrid"):
            p["ssm"] = ssd.init_ssm(gen, cfg, wdt, pd, device)
        if cfg.family == "hybrid":   # learned attention/SSM fusion
            p["mix_scale"] = torch.zeros(2, dtype=pd, device=device)
        if cfg.family == "moe":
            p["ffn"] = moe.init_moe(gen, cfg, wdt, pd, device)
        elif cfg.family in ("dense", "vlm", "audio", "hybrid"):
            p["ffn"] = init_mlp(gen, cfg, wdt, device)
        if "ffn" in p:
            p["ln2"] = torch.zeros(cfg.d_model, dtype=pd, device=device)
        if cfg.is_encoder_decoder:
            p["xattn"] = attn.init_attention(gen, cfg, wdt, device,
                                             cross=True)
            p["lnx"] = torch.zeros(cfg.d_model, dtype=pd, device=device)
        return p

    def _init_encoder_layer(self, gen: torch.Generator, device,
                            wdt: torch.dtype) -> Dict:
        cfg = self.cfg
        pd = self.param_dtype
        return {"ln1": torch.zeros(cfg.d_model, dtype=pd, device=device),
                "attn": attn.init_attention(gen, cfg, wdt, device),
                "ln2": torch.zeros(cfg.d_model, dtype=pd, device=device),
                "ffn": init_mlp(gen, cfg, wdt, device)}

    def init(self, gen: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Params on ``gen.device`` drawn from ``gen``: the reference's
        distributions (truncated normal, σ = 1/√fan_in; zero norms). Matrices
        are stored in ``dtype``, by default the compute dtype — the
        reference casts its fp32 params to it before every product, so the
        products are the same — and the leaves it uses in fp32 (norms, the
        SSM's conv, decay, step, skip and gate weights, the hybrid's mix
        scales) in the param dtype. Training passes the param dtype: the
        reference keeps every leaf in it, and Adam updates them there. The
        draws do not depend on ``dtype``."""
        cfg = self.cfg
        dev = gen.device
        wdt = dtype or self.compute_dtype
        params: Dict = {
            "embed": init_embed(gen, cfg, wdt, dev),
            "final_norm": torch.zeros(cfg.d_model, dtype=self.param_dtype,
                                      device=dev)}
        params["layers"] = _draw_stacked(
            cfg.num_layers, lambda: self._init_layer(gen, dev, wdt))
        if cfg.is_encoder_decoder:
            params["enc_layers"] = _draw_stacked(
                cfg.enc_layers,
                lambda: self._init_encoder_layer(gen, dev, wdt))
            params["enc_in"] = truncated_normal_init(
                gen, (AUDIO_FRAME_DIM, cfg.d_model), 1.0, wdt, dev)
            params["enc_norm"] = torch.zeros(cfg.d_model,
                                             dtype=self.param_dtype,
                                             device=dev)
        if cfg.frontend == "vision_patches":
            params["vis_proj"] = truncated_normal_init(
                gen, (VISION_EMBED_DIM, cfg.d_model), 1.0, wdt, dev)
        return params

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _layers(self, params: Dict, key: str = "layers") -> List[Dict]:
        """Per-layer views of the stacked leaves of ``params[key]`` (the
        decoder's ``layers``, ``num_layers`` of them, or the encoder's
        ``enc_layers``, ``enc_layers`` of them), cached per stack for the
        last params seen (the hot decode loop would otherwise re-slice
        every step). Under autograd they are made anew for each call and
        never cached: the gradients must flow through this call's views
        into this call's leaves, and a cached view would keep the last
        step's graph and leaves alive."""
        stacked = params[key]
        n = self.cfg.num_layers if key == "layers" else self.cfg.enc_layers
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in _leaves(stacked)):
            return _unstack(stacked, n)
        seen = self._layers_of.get(key)
        if seen is None or seen[0] is not stacked:
            seen = self._layers_of[key] = (stacked, _unstack(stacked, n))
        return seen[1]

    def _positions_table(self, S: int, device,
                         dtype: torch.dtype) -> torch.Tensor:
        """``sinusoidal_positions(S, D)`` on ``device`` in ``dtype``, made
        once per (S, device, dtype): a host-to-device copy cannot run
        inside a captured step."""
        key = (S, device, dtype)
        if key not in self._pos_tables:
            self._pos_tables[key] = torch.as_tensor(sinusoidal_positions(
                S, self.cfg.d_model)).to(device=device, dtype=dtype)
        return self._pos_tables[key]

    def _sinusoid_pe(self, positions: torch.Tensor) -> torch.Tensor:
        """Sinusoidal rows for integer ``positions`` of any shape ->
        ``positions.shape + (d_model,)`` fp32, with fp32 angles computed on
        the device (the reference's per-position form; it differs from
        ``sinusoidal_positions``' float64 angles in the last bits at large
        positions)."""
        half = self.cfg.d_model // 2
        inv = 1.0 / (10_000.0 ** (torch.arange(
            half, device=positions.device) / half))
        ang = positions[..., None].float() * inv
        pe = torch.zeros(positions.shape + (self.cfg.d_model,),
                         dtype=torch.float32, device=positions.device)
        pe[..., 0::2] = torch.sin(ang)
        pe[..., 1::2] = torch.cos(ang)
        return pe

    def _cross(self, lp: Dict, x: torch.Tensor,
               enc: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoder-decoder layer's cross-attention sub-block over the
        encoder output ``enc`` (nothing without one)."""
        if enc is None:
            return x
        h = rms_norm(x, lp["lnx"], self.cfg.norm_eps)
        return x + attn.cross_attention(self.cfg, lp["xattn"], h, enc)

    def _logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(cfg, params["embed"], x)
        key = (logits.device, logits.dtype)
        if key not in self._vmask:
            self._vmask[key] = torch.as_tensor(self._vmask_np).to(
                device=logits.device, dtype=logits.dtype)
        return logits + self._vmask[key]

    def _ffn(self, lp: Dict, x: torch.Tensor,
             auxes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The FFN sub-block where the layer has one (not the SSM family):
        the gated MLP, or the MoE layer over this call's tokens, whose
        ``aux_loss`` is appended to ``auxes`` when given."""
        if "ffn" not in lp:
            return x
        cfg = self.cfg
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.family != "moe":
            return x + apply_mlp(cfg, lp["ffn"], h)
        y, metrics = moe.apply_moe(cfg, lp["ffn"], h,
                                   metrics=auxes is not None)
        if auxes is not None:
            auxes.append(metrics["aux_loss"])
        return x + y

    @staticmethod
    def _mix(lp: Dict, x: torch.Tensor, a: Optional[torch.Tensor],
             s: Optional[torch.Tensor]) -> torch.Tensor:
        """Residual add of the token mixer: attention ``a``, SSM ``s``, or
        the hybrid's ``sigmoid(mix_scale)``-weighted sum of both in fp32."""
        if s is None:
            return x + a
        if a is None:
            return x + s
        sc = torch.sigmoid(lp["mix_scale"].float())
        return x + (sc[0] * a.float() + sc[1] * s.float()).to(x.dtype)

    # ------------------------------------------------------------------
    # full-sequence forward (teacher forcing) and the training loss
    # ------------------------------------------------------------------
    def _block(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
               w: int, enc: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer over the full sequence -> (x, the MoE layer's
        ``aux_loss`` or None)."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a = (attn.attention_forward(cfg, lp["attn"], h, positions, w)
             if "attn" in lp else None)
        s = ssd.ssm_forward(cfg, lp["ssm"], h) if "ssm" in lp else None
        auxes: List[torch.Tensor] = []
        x = self._ffn(lp, self._cross(lp, self._mix(lp, x, a, s), enc),
                      auxes)
        return x, (auxes[0] if auxes else None)

    # ------------------------------------------------------------------
    # encoder (whisper) and the embedded input sequence
    # ------------------------------------------------------------------
    def encode(self, params: Dict, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, AUDIO_FRAME_DIM) -> the encoder's output (B, T, D):
        ``enc_in``, the sinusoid table, ``enc_layers`` layers of unmasked
        self-attention and MLP (plain tensor code: the reference reaches no
        kernel here), ``enc_norm``."""
        cfg = self.cfg
        dt = self.compute_dtype
        x = frames.to(dt) @ params["enc_in"].to(dt)
        x = x + self._positions_table(frames.shape[1], x.device, dt)[None]
        for lp in self._layers(params, "enc_layers"):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + attn.bidirectional_attention(cfg, lp["attn"], h)
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + apply_mlp(cfg, lp["ffn"], h2)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _embed_inputs(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The token embeddings, after the projected image prefix where the
        batch has ``patch_embeds`` (VLM), plus the sinusoid table over the
        whole sequence for ``rope_theta <= 0`` and the encoder-decoder
        family -> (B, S, D), S counting the prefix."""
        cfg = self.cfg
        dt = self.compute_dtype
        x = embed(cfg, params["embed"], batch["tokens"], dt)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            vis = batch["patch_embeds"].to(dt) @ params["vis_proj"].to(dt)
            x = torch.cat([vis, x], dim=1)
        if cfg.rope_theta <= 0 or cfg.is_encoder_decoder:
            x = x + self._positions_table(x.shape[1], x.device, dt)[None]
        return x

    def apply(self, params: Dict, batch: Dict, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) (with ``patch_embeds`` for the VLM, ``frames`` for
        the encoder-decoder family) -> (logits (B, P + S, V), P the image
        prefix, the layers' mean MoE ``aux_loss``, 0 without MoE). With
        ``train`` and ``cfg.remat`` each layer is checkpointed: only its
        input is kept for the backward pass, which runs the layer again."""
        cfg = self.cfg
        enc = (self.encode(params, batch["frames"])
               if cfg.is_encoder_decoder else None)
        x = self._embed_inputs(params, batch)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        auxes: List[torch.Tensor] = []
        for lp, w in zip(self._layers(params), self._windows):
            if cfg.remat and train:
                x, aux = checkpoint(self._block, lp, x, positions, w, enc,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._block(lp, x, positions, w, enc)
            if aux is not None:
                auxes.append(aux)
        # the mean of the layers' load-balance losses (0 without MoE), as
        # the reference's _run_layers
        aux = (torch.stack(auxes).sum() / cfg.num_layers if auxes
               else torch.zeros((), device=x.device))
        return self._logits(params, x), aux

    def loss(self, params: Dict, batch: Dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy over the labels >= 0 (label -1 is
        masked), in fp32, plus ``aux_loss_coef`` times the MoE aux loss ->
        (total, {"ce_loss", "aux_loss"}), as the reference's ``loss``; the
        logits of an image prefix have no labels and are dropped."""
        cfg = self.cfg
        logits, aux = self.apply(params, batch, train=True)
        labels = batch["labels"]
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = loss + cfg.aux_loss_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux}

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_capacity(self, max_len: int) -> int:
        """Ring capacity of the K/V cache. With a sliding window it is
        ``min(max_len, window)`` for every layer — in the hybrid family
        also for its global layers (window 0), which attend over the same
        ring (reference ``model.py:270-276``)."""
        cfg = self.cfg
        if cfg.sliding_window:        # every family and every layer
            return min(max_len, cfg.sliding_window)
        return max_len

    def init_cache(self, batch_size: int, max_len: int,
                   device: torch.device) -> Dict:
        """``pos`` (B,); ``k``/``v`` (L,B,KV,C,hd) except for the SSM family;
        for SSM and hybrid ``conv`` (L,B,cw-1,di+2N) in the compute dtype and
        ``ssd`` (L,B,H,hp,N) in fp32; for the encoder-decoder family the
        encoder output ``enc`` (B, enc_seq, D)."""
        cfg = self.cfg
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        cache = {"pos": torch.zeros(batch_size, dtype=torch.int64,
                                    device=device)}
        if cfg.family != "ssm":
            C = self.cache_capacity(max_len)
            # (L, B, KV, C, hd): the decode kernel's native operand layout
            shape = (L, batch_size, KV, C, hd)
            cache["k"] = torch.zeros(shape, dtype=self.compute_dtype,
                                     device=device)
            cache["v"] = torch.zeros(shape, dtype=self.compute_dtype,
                                     device=device)
        if cfg.family in ("ssm", "hybrid"):
            ch = cfg.d_inner + 2 * cfg.ssm_state
            cache["conv"] = torch.zeros(
                (L, batch_size, cfg.conv_width - 1, ch),
                dtype=self.compute_dtype, device=device)
            cache["ssd"] = torch.zeros(
                (L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=device)
        if cfg.is_encoder_decoder:
            cache["enc"] = torch.zeros((batch_size, cfg.enc_seq, cfg.d_model),
                                       dtype=self.compute_dtype,
                                       device=device)
        return cache

    # ------------------------------------------------------------------
    # prefill: run the full prompt, build the cache
    # ------------------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """The prompt (an image prefix and the encoder's output included)
        through every layer -> (last position's logits (B, V), a fresh
        cache of capacity ``max_len`` (default: the sequence) with ``pos``
        at the sequence's length S, the prefix counted)."""
        cfg = self.cfg
        enc = (self.encode(params, batch["frames"])
               if cfg.is_encoder_decoder else None)
        x = self._embed_inputs(params, batch)
        B, S = x.shape[0], x.shape[1]
        dev = x.device
        C = self.cache_capacity(max_len or S)
        cache = self.init_cache(B, max_len or S, dev)
        cache["pos"].fill_(S)
        if enc is not None:
            cache["enc"] = enc
        positions = torch.arange(S, device=dev).expand(B, S)
        if S >= C:
            # keep the last C positions, ring-aligned: slot = pos % C
            slots = (torch.arange(C, device=dev) + (S - C) % C) % C
        for i, (lp, w) in enumerate(zip(self._layers(params), self._windows)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a = s = None
            if "attn" in lp:
                # The hybrid's windows differ per layer: the reference's scan
                # then passes a traced window and takes its jnp path, while
                # this loop passes each layer's static int (the flash_prefill
                # kernel with use_kernels) — the same numbers.
                a, k, v = attn.attention_forward(cfg, lp["attn"], h,
                                                 positions, w, return_kv=True)
                # The reference recomputes K/V from the same normed input for
                # its cache (model.py:609-617); the roped k and v attention
                # just used are the same math, so they are written directly.
                k, v = k.transpose(1, 2), v.transpose(1, 2)    # (B,KV,S,hd)
                if S >= C:
                    cache["k"][i][:, :, slots] = k[:, :, S - C:]
                    cache["v"][i][:, :, slots] = v[:, :, S - C:]
                else:
                    cache["k"][i][:, :, :S] = k
                    cache["v"][i][:, :, :S] = v
            if "ssm" in lp:
                s, (conv_st, ssd_st) = ssd.ssm_forward(cfg, lp["ssm"], h,
                                                       return_cache=True)
                cache["conv"][i].copy_(conv_st)
                cache["ssd"][i].copy_(ssd_st)
            x = self._ffn(lp, self._cross(lp, self._mix(lp, x, a, s), enc))
        return self._logits(params, x[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    # one-token decode against the cache
    # ------------------------------------------------------------------
    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) -> (logits (B, V), cache): the token's K/V and the
        SSM's new conv/SSD states land in ``cache`` in place and
        ``cache["pos"]`` advances by one. The encoder-decoder family
        attends over ``cache["enc"]``, projecting its K and V anew."""
        cfg = self.cfg
        dt = self.compute_dtype
        pos = cache["pos"]
        x = embed(cfg, params["embed"], tokens[:, None], dt)
        if cfg.rope_theta <= 0 or cfg.is_encoder_decoder:
            x = x + self._sinusoid_pe(pos)[:, None, :].to(dt)
        enc = cache.get("enc")
        for i, (lp, w) in enumerate(zip(self._layers(params), self._windows)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a = s = None
            if "attn" in lp:
                a, _, _ = attn.decode_attention(cfg, lp["attn"], h,
                                                cache["k"][i], cache["v"][i],
                                                pos, w)
            if "ssm" in lp:
                s, conv_st, ssd_st = ssd.ssm_decode(cfg, lp["ssm"], h,
                                                    cache["conv"][i],
                                                    cache["ssd"][i])
                cache["conv"][i].copy_(conv_st)
                cache["ssd"][i].copy_(ssd_st)
            x = self._ffn(lp, self._cross(lp, self._mix(lp, x, a, s), enc))
        pos.add_(1)
        return self._logits(params, x)[:, 0], cache

    # ------------------------------------------------------------------
    # paged KV cache (shared page pool + per-slot block tables)
    # ------------------------------------------------------------------
    def supports_paged_cache(self) -> bool:
        """Paged decode covers the pure-attention KV families without a
        sliding window (a window implies the ring discipline)."""
        cfg = self.cfg
        return (cfg.family in ("dense", "moe", "vlm")
                and not cfg.is_encoder_decoder and not cfg.sliding_window)

    def supports_chunked_prefill(self) -> bool:
        """Prefill continuation needs positional KV state and the non-ring
        slot == position discipline: the paged predicate."""
        return self.supports_paged_cache()

    def init_paged_cache(self, batch_size: int, pool_pages: int,
                         page_size: int, max_pages_per_seq: int,
                         device: torch.device) -> Dict:
        """``kp``/``vp``: the shared page pool ``(L, KV, pool_pages,
        page_size, hd)``; ``pt``: the per-slot block table, int32 (the
        kernel's operand type), all rows the trash page 0; ``pos``: each
        slot's next position. Which pages are free or owned is host-side
        bookkeeping (``attention.PagedKVCache``)."""
        cfg = self.cfg
        assert self.supports_paged_cache(), \
            f"paged KV cache unsupported for config {cfg.name!r}"
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        shape = (L, KV, pool_pages, page_size, hd)
        return {"pos": torch.zeros(batch_size, dtype=torch.int64,
                                   device=device),
                "kp": torch.zeros(shape, dtype=self.compute_dtype,
                                  device=device),
                "vp": torch.zeros(shape, dtype=self.compute_dtype,
                                  device=device),
                "pt": torch.zeros((batch_size, max_pages_per_seq),
                                  dtype=torch.int32, device=device)}

    def paged_admit(self, cache: Dict, prefill_cache: Dict,
                    cur_tok: torch.Tensor, first_tok: torch.Tensor,
                    page_ids: torch.Tensor, dest_slots: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """Scatter ``b`` prefilled rows into the page pool, in place.

        ``prefill_cache`` comes from ``prefill(..., max_len=prompt_len)``;
        ``page_ids`` (b, max_pages_per_seq) are the block-table rows the
        pool manager allocated; ``dest_slots`` (b,) the receiving slots.
        Rows of a partly filled admission bucket carry out-of-bounds page
        ids and slots: the reference drops them with ``mode="drop"``
        scatters, here they are filtered out before the writes (an index
        out of bounds raises in torch). Returns (cache, cur_tok)."""
        kp, vp, pt, pos = cache["kp"], cache["vp"], cache["pt"], cache["pos"]
        P, ps = kp.shape[2], kp.shape[3]
        k_new, v_new = prefill_cache["k"], prefill_cache["v"]  # (L,b,KV,S,hd)
        L, b, KV, S, hd = k_new.shape
        pp = -(-S // ps)                       # pages holding the prompt
        pad = pp * ps - S
        if pad:
            k_new = torch.nn.functional.pad(k_new, (0, 0, 0, pad))
            v_new = torch.nn.functional.pad(v_new, (0, 0, 0, pad))
        # (L, KV, b, pp, ps, hd): the pool's gather shape
        k_new = k_new.reshape(L, b, KV, pp, ps, hd).transpose(1, 2)
        v_new = v_new.reshape(L, b, KV, pp, ps, hd).transpose(1, 2)
        page_ids = page_ids.to(pt.device)
        dest = dest_slots.to(pt.device)
        pages = page_ids[:, :pp]
        live = (pages >= 0) & (pages < P)                      # (b, pp)
        kp[:, :, pages[live]] = k_new[:, :, live].to(kp.dtype)
        vp[:, :, pages[live]] = v_new[:, :, live].to(vp.dtype)
        rows = (dest >= 0) & (dest < pt.shape[0])
        pt[dest[rows]] = page_ids[rows].to(pt)
        pos[dest[rows]] = prefill_cache["pos"][rows].to(pos)
        cur_tok[dest[rows]] = first_tok[rows].to(cur_tok)
        return cache, cur_tok

    def paged_cow_copy(self, cache: Dict, src: int, dst: int) -> Dict:
        """Copy one pool page's K/V across every layer, in place: the device
        half of admission-time copy-on-write (a fully matched boundary
        block is duplicated into the request's own fresh page, so its
        writes never touch the shared original)."""
        cache["kp"][:, :, dst] = cache["kp"][:, :, src]
        cache["vp"][:, :, dst] = cache["vp"][:, :, src]
        return cache

    def paged_retire(self, cache: Dict, slot: int) -> Dict:
        """Point a retiring slot's block-table row back at the trash page
        and reset its position, so the batch row decodes harmlessly until
        the next admission."""
        cache["pt"][slot] = 0
        cache["pos"][slot] = 0
        return cache

    # ------------------------------------------------------------------
    # prefill continuation: one chunk of prompt tokens at an offset
    # ------------------------------------------------------------------
    def _finish_chunk(self, x: torch.Tensor, params: Dict,
                      n_valid: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed at each row's last valid chunk position ->
        logits (B, V) (garbage rows where n_valid == 0). The norm is
        per-position, so selecting the row first is the same math."""
        B, ck = x.shape[0], x.shape[1]
        last = torch.clamp(n_valid - 1, 0, ck - 1)
        rows = torch.arange(B, device=x.device)
        return self._logits(params, x[rows, last][:, None])[:, 0]

    def _chunk_trunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                     start: torch.Tensor, n_valid: torch.Tensor, *,
                     paged: bool) -> Tuple[torch.Tensor, Dict]:
        """Embed the (B, ck) chunk at per-row ``start`` offsets and run
        every layer, writing the chunk's K/V into the dense cache
        (``paged=False``) or each row's block-table pages (``paged=True``);
        returns (pre-final-norm activations (B, ck, D), cache) with ``pos``
        advanced to ``start + n_valid`` on active rows. Rows with
        ``n_valid == 0`` are inert: no writes, no advance."""
        cfg = self.cfg
        assert self.supports_chunked_prefill(), \
            f"chunked prefill unsupported for config {cfg.name!r}"
        dt = self.compute_dtype
        x = embed(cfg, params["embed"], tokens, dt)
        if cfg.rope_theta <= 0:
            positions = start[:, None] + torch.arange(
                tokens.shape[1], device=tokens.device)[None, :]
            x = x + self._sinusoid_pe(positions).to(dt)
        if not paged:          # one validity bias for every layer
            bias = attn.chunk_bias(start, tokens.shape[1],
                                   cache["k"][0].shape[2])
        for i, lp in enumerate(self._layers(params)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if paged:
                a, _, _ = attn.paged_chunk_prefill_attention(
                    cfg, lp["attn"], h, cache["kp"][i], cache["vp"][i],
                    cache["pt"], start, n_valid)
            else:
                a, _, _ = attn.chunk_prefill_attention(
                    cfg, lp["attn"], h, cache["k"][i], cache["v"][i], start,
                    n_valid, bias)
            x = self._ffn(lp, x + a)
        pos = cache["pos"]
        pos.copy_(torch.where(n_valid > 0, start + n_valid, pos))
        return x, cache

    def prefill_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                      start: torch.Tensor, n_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict]:
        """Continue prompt prefill by one chunk against the dense cache.

        tokens: (B, ck) — each prefilling row's next chunk, right-padded;
        start: (B,) absolute position of tokens[:, 0]; n_valid: (B,) real
        tokens this chunk (0 = row inert: no writes, no advance). The
        chunk's K/V lands at cache slots ``start..start+n_valid`` and every
        chunk query attends over the cached prefix plus the chunk itself:
        run over a whole prompt in chunks this reproduces ``prefill``. A
        decode step is a one-token continuation, so fused ticks run decoding
        rows through here too. Returns (logits at each row's last valid
        token (B, V), cache), updated in place."""
        x, cache = self._chunk_trunk(params, cache, tokens, start, n_valid,
                                     paged=False)
        return self._finish_chunk(x, params, n_valid), cache

    def prefill_chunk_paged(self, params: Dict, cache: Dict,
                            tokens: torch.Tensor, start: torch.Tensor,
                            n_valid: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict]:
        """``prefill_chunk`` against the paged pool: the chunk's K/V lands
        in each row's block-table pages (allocated at admission). Same
        contract and return shape as the dense form."""
        x, cache = self._chunk_trunk(params, cache, tokens, start, n_valid,
                                     paged=True)
        return self._finish_chunk(x, params, n_valid), cache

    # ------------------------------------------------------------------
    # speculative verify: the chunk trunk with a head at every position
    # ------------------------------------------------------------------
    def _verify_finish(self, x: torch.Tensor, params: Dict) -> torch.Tensor:
        """Final norm + unembed at every chunk position -> greedy argmax
        (B, ck) int64: verification needs the target's prediction at each
        proposed position, not only at the row's last valid one."""
        return torch.argmax(self._logits(params, x), dim=-1)

    def verify_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                     start: torch.Tensor, n_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict]:
        """Score a (B, k+1) slice of proposed tokens at per-row offsets in
        one call (the verify of speculative decoding). ``tokens[:, 0]`` is
        each row's last committed token, the rest are drafts; the argmax at
        position j is what target-only greedy decoding emits after
        consuming ``tokens[:, :j+1]``. The chunk's K/V is written like a
        prefill continuation's; the engine discards rejected positions by
        rewinding ``pos`` (slots past a row's position are never attended
        before they are written again). Returns (argmax (B, ck), cache),
        updated in place."""
        x, cache = self._chunk_trunk(params, cache, tokens, start, n_valid,
                                     paged=False)
        return self._verify_finish(x, params), cache

    def verify_chunk_paged(self, params: Dict, cache: Dict,
                           tokens: torch.Tensor, start: torch.Tensor,
                           n_valid: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict]:
        """``verify_chunk`` against the paged pool; same contract."""
        x, cache = self._chunk_trunk(params, cache, tokens, start, n_valid,
                                     paged=True)
        return self._verify_finish(x, params), cache

    # ------------------------------------------------------------------
    # one-token decode against the paged pool
    # ------------------------------------------------------------------
    def decode_step_paged(self, params: Dict, cache: Dict,
                          tokens: torch.Tensor, *, n_pages: int
                          ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) -> (logits (B, V), cache). Paged counterpart of
        ``decode_step``: per-layer attention runs against the shared pool
        through each slot's block table, over its first ``n_pages`` columns
        (the caller's live-page bucket); ``pt`` and ``pos`` are shared by
        all layers. Pool writes and the ``pos`` advance happen in place."""
        cfg = self.cfg
        assert self.supports_paged_cache(), cfg.name
        dt = self.compute_dtype
        pos = cache["pos"]
        x = embed(cfg, params["embed"], tokens[:, None], dt)
        if cfg.rope_theta <= 0:
            x = x + self._sinusoid_pe(pos)[:, None, :].to(dt)
        pt = cache["pt"]
        for i, lp in enumerate(self._layers(params)):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = attn.paged_decode_attention(
                cfg, lp["attn"], h, cache["kp"][i], cache["vp"][i], pt, pos,
                n_pages=n_pages)
            x = self._ffn(lp, x + a)
        pos.add_(1)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ModelConfig) -> LM:
    """A new ``LM`` for ``cfg``. The reference caches its models per config
    (each holds its jitted steps); the port keeps none process-wide: an
    ``LM`` keeps per-layer views of the last params it ran, so a shared
    cache would hold a retired variant's layer weights for the life of the
    process. Keep the model with the params it runs, as a serving backend
    does."""
    return LM(cfg)

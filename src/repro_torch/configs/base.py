"""Model/config registry of the PyTorch port.

``ModelConfig`` carries every field of the reference package's config, so
one field dict builds both (the reference's ``use_pallas`` is
``use_kernels`` here: it routes attention and the SSD scan through the
hand-written CUDA kernels). ``REGISTRY`` maps ``--arch <id>`` names to full published configs;
``smoke_variant(cfg)`` derives the reduced CPU-testable config (<=2 layers,
d_model<=512, <=4 experts) from the same family. Registered: every
architecture of the reference's registry (dense tinyllama-1.1b, gemma-2b,
yi-6b and deepseek-67b, MoE granite-moe-3b-a800m and qwen3-moe-235b-a22b,
SSM mamba2-130m, hybrid hymba-1.5b, VLM internvl2-26b, encoder-decoder
whisper-tiny).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

VOCAB_PAD_MULTIPLE = 256  # pad vocab so it shards over the 16-way model axis


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm | resnet
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128
    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention
    global_layer_every: int = 0    # hybrid: every k-th layer uses full attn
    attn_logit_softcap: float = 0.0
    # --- block wiring ---
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- encoder/decoder (whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500            # encoder frames (stub frontend output length)
    # --- multimodal stub frontend ---
    frontend: str = ""             # "" | "audio_frames" | "vision_patches"
    num_frontend_tokens: int = 0
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_kernels: bool = False      # attention/SSD scan through CUDA kernels
    remat: bool = True
    scan_layers: bool = True   # False: unroll (dry-run cost analysis counts
    #                            a scan body once; unrolling keeps it honest)
    source: str = ""               # citation (paper / model card)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size) if self.vocab_size else 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if a 500k-token decode is sub-quadratic for this config."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter count (used for accuracy-proxy scaling laws & rooflines).
    def param_count(self) -> int:
        D, F, L = self.d_model, self.d_ff, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = 0
        if self.vocab_size:
            n += self.padded_vocab * D          # embed
            if not self.tie_embeddings:
                n += D * self.padded_vocab      # lm head
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D   # qkvo
        if self.family in ("dense", "vlm", "audio"):
            n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += n_mats * D * F
        elif self.family == "moe":
            per_layer += D * self.num_experts   # router
            per_layer += self.num_experts * 3 * D * F
        if self.family in ("ssm", "hybrid"):
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            proj_in = 2 * di + 2 * N + Hs       # z,x,B,C,dt (ngroups=1)
            per_layer += D * proj_in + di * D + self.conv_width * (di + 2 * N)
        if self.family == "hybrid":
            n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += n_mats * D * F
        per_layer += 2 * D                      # norms
        n += L * per_layer
        if self.is_encoder_decoder:
            # encoder layers + cross attention in decoder
            enc = self.enc_layers * (4 * D * H * hd + 2 * D * F + 2 * D)
            cross = L * (D * H * hd + 2 * D * KV * hd + H * hd * D + D)
            n += enc + cross
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top-k of experts)."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        dense = self.param_count() - L * self.num_experts * 3 * D * F
        return dense + L * self.experts_per_token * 3 * D * F


REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]()


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    head_dim = min(cfg.resolved_head_dim, 64)
    heads = max(2, min(cfg.num_heads, d_model // head_dim)) if cfg.num_heads else 0
    kv = max(1, min(cfg.num_kv_heads, heads)) if cfg.num_kv_heads else 0
    if heads and kv:
        while heads % kv:
            kv -= 1
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim if cfg.num_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 32),
        num_frontend_tokens=min(cfg.num_frontend_tokens, 8),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    if cfg.is_moe:
        # dropless at test scale so decode == teacher forcing exactly
        kw.update(num_experts=4, experts_per_token=2, moe_capacity_factor=16.0)
    return cfg.replace(**kw)

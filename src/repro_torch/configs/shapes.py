"""Assigned input shapes and per-(arch, shape) applicability rules."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


# Sliding-window width used to make full-attention archs sub-quadratic for
# long_500k (documented in DESIGN.md §Arch-applicability).
LONG_CONTEXT_WINDOW = 8_192


def adapt_config_for_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[Optional[ModelConfig], str]:
    """Returns (possibly adapted config, note) or (None, skip reason)."""
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return None, (
                "SKIP: enc-dec audio decoder; 500k-token autoregressive decode "
                "is outside the family scope (full attention, no sub-quadratic "
                "variant in the Whisper family). See DESIGN.md."
            )
        if cfg.family in ("ssm", "hybrid"):
            return cfg, "native sub-quadratic (SSM state / windowed attention)"
        if cfg.sliding_window == 0:
            return (
                cfg.replace(sliding_window=LONG_CONTEXT_WINDOW),
                f"sliding-window({LONG_CONTEXT_WINDOW}) decode variant "
                "(documented sub-quadratic adaptation)",
            )
    return cfg, ""


def pairs(configs: List[ModelConfig]) -> List[Tuple[ModelConfig, InputShape, str]]:
    """All runnable (config, shape) pairs with adaptation notes."""
    out = []
    for cfg in configs:
        for shape in SHAPES.values():
            adapted, note = adapt_config_for_shape(cfg, shape)
            if adapted is not None:
                out.append((adapted, shape, note))
    return out

"""granite-moe-3b-a800m — 40-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from .base import ModelConfig, register


@register
def granite_moe_3b_a800m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                # per-expert FFN width
        vocab_size=49155,
        num_experts=40,
        experts_per_token=8,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (Granite MoE family)",
    )

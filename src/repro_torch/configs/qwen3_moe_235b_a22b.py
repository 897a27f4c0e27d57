"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B family]."""
from .base import ModelConfig, register


@register
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,               # per-expert FFN width
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE family)",
    )

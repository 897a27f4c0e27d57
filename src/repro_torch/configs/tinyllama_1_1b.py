"""tinyllama-1.1b — llama2-architecture small dense LM [arXiv:2401.02385]."""
from .base import ModelConfig, register


@register
def tinyllama_1_1b() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        rope_theta=10_000.0,
        source="arXiv:2401.02385 (TinyLlama)",
    )

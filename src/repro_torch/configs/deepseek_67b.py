"""deepseek-67b — llama-architecture dense, 95 layers GQA kv=8 [arXiv:2401.02954]."""
from .base import ModelConfig, register


@register
def deepseek_67b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=10_000.0,
        source="arXiv:2401.02954 (DeepSeek LLM 67B)",
    )

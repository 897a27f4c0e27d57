"""gemma-2b — GeGLU MLP, head_dim 256, MQA (kv=1) [arXiv:2403.08295]."""
from .base import ModelConfig, register


@register
def gemma_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp_type="geglu",
        tie_embeddings=True,
        source="arXiv:2403.08295 (Gemma 2B)",
    )

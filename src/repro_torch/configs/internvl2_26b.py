"""internvl2-26b — VLM: InternViT vision encoder (stubbed frontend providing
patch embeddings) + InternLM2-style dense LM backbone [arXiv:2404.16821]."""
from .base import ModelConfig, register


@register
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision_patches",
        num_frontend_tokens=256,   # one image tile worth of projected patches
        rope_theta=1_000_000.0,
        source="arXiv:2404.16821 (InternVL2; LM=InternLM2-20B-style)",
    )

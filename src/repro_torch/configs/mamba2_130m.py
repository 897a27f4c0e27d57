"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from .base import ModelConfig, register


@register
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        expand=2,
        conv_width=4,
        tie_embeddings=True,
        source="arXiv:2405.21060 (Mamba-2, SSD)",
    )

"""whisper-tiny — encoder-decoder ASR backbone; conv/mel frontend stubbed
per assignment (input_specs() provides precomputed frame embeddings)
[arXiv:2212.04356]."""
from .base import ModelConfig, register


@register
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,            # decoder layers
        enc_layers=4,
        enc_seq=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        is_encoder_decoder=True,
        frontend="audio_frames",
        mlp_type="gelu",
        rope_theta=0.0,          # whisper uses learned/sinusoidal positions
        source="arXiv:2212.04356 (Whisper)",
    )

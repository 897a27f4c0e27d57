"""hymba-1.5b — hybrid: parallel attention + Mamba heads per block
[arXiv:2411.13676]. Sliding-window attention on most layers (full attention
every 8th layer), matching the Hymba design; SSM path gives O(1) state so
long_500k decode is native."""
from .base import ModelConfig, register


@register
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_head_dim=64,
        expand=2,
        sliding_window=1024,
        global_layer_every=8,
        source="arXiv:2411.13676 (Hymba)",
    )

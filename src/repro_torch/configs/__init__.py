"""Config registry: every architecture of the reference's registry (dense
tinyllama-1.1b, gemma-2b, yi-6b and deepseek-67b, MoE granite-moe-3b-a800m
and qwen3-moe-235b-a22b, SSM mamba2-130m, hybrid hymba-1.5b, the VLM
internvl2-26b and the encoder-decoder whisper-tiny; see ``base``) and the
assigned input shapes (``shapes``)."""
from . import (deepseek_67b, gemma_2b, granite_moe_3b_a800m,  # noqa: F401
               hymba_1_5b, internvl2_26b, mamba2_130m, qwen3_moe_235b_a22b,
               tinyllama_1_1b, whisper_tiny, yi_6b)  # (registration side effects)
from .base import REGISTRY, ModelConfig, get_config, smoke_variant  # noqa: F401
from .shapes import (SHAPES, InputShape, adapt_config_for_shape,  # noqa: F401
                     get_shape, pairs)

ALL_ARCHS = sorted(REGISTRY)

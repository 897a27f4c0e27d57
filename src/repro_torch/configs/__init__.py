"""Config registry: the architectures whose model families are ported
(dense tinyllama-1.1b, SSM mamba2-130m, hybrid hymba-1.5b; see ``base``)."""
from . import hymba_1_5b, mamba2_130m, tinyllama_1_1b  # noqa: F401  (registers)
from .base import REGISTRY, ModelConfig, get_config, smoke_variant  # noqa: F401

"""Config registry (dense tinyllama-1.1b so far; see ``base``)."""
from . import tinyllama_1_1b  # noqa: F401  (registers the config)
from .base import REGISTRY, ModelConfig, get_config, smoke_variant  # noqa: F401

from .base import (EncDecConfig, HybridConfig, LoRAConfig, ModelConfig,
                   MoEConfig, SHAPES, SSMConfig, ShapeConfig, VLMConfig,
                   smoke_shape)
from .registry import ASSIGNED, get_config, list_archs, smoke_config

__all__ = [
    "EncDecConfig", "HybridConfig", "LoRAConfig", "ModelConfig", "MoEConfig",
    "SHAPES", "SSMConfig", "ShapeConfig", "VLMConfig", "smoke_shape",
    "ASSIGNED", "get_config", "list_archs", "smoke_config",
]

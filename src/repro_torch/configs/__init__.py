from repro_torch.configs.base import (
    ModelConfig,
    Shape,
    SHAPES,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "ModelConfig",
    "Shape",
    "SHAPES",
    "get_config",
    "get_smoke_config",
    "list_archs",
]

from repro_torch.configs.base import (
    ALL_SHAPES,
    ARCH_IDS,
    PAPER_ARCH_IDS,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeSpec,
    get_config,
    get_reduced_config,
)

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "PAPER_ARCH_IDS",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_reduced_config",
]

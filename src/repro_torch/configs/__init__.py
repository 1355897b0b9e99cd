"""Architecture configs: the reference's ten LM architectures, as data."""

from repro_torch.configs.base import ModelConfig, ShapeConfig, ArchSpec, SHAPES
from repro_torch.configs.registry import get_arch, list_archs, smoke_config

__all__ = ["ModelConfig", "ShapeConfig", "ArchSpec", "SHAPES",
           "get_arch", "list_archs", "smoke_config"]

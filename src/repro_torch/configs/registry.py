"""Architecture registry: ``--arch <id>`` resolution (the reference's
``configs/registry.py``).  The reference's ``input_specs`` and
``cache_specs`` build dry-run stand-ins (``ShapeDtypeStruct``,
``NamedSharding``); they are ROADMAP item 13e."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec, ModelConfig

_ARCH_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.ARCH


def smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.SMOKE

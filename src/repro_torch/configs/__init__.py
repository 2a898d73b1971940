"""Architecture config registry: ``get_config("qwen3-8b")`` etc.

Every architecture of ``repro``'s registry has its own module with
``config()`` (exact published numbers) and ``smoke_config()`` (reduced
same-family variant), copied from ``repro.configs``.
"""

from __future__ import annotations

import importlib

from repro_torch.shapes import (
    SHAPES,
    SUB_QUADRATIC,
    ShapeSpec,
    shape_applicable,
    smoke_shape,
)
from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCH_IDS = ("whisper-small", "qwen3-8b", "mistral-nemo-12b", "granite-3-2b",
            "mistral-large-123b", "mamba2-1.3b", "recurrentgemma-9b", "mixtral-8x7b",
            "olmoe-1b-7b", "qwen2-vl-72b")


def _normalize(arch_id: str) -> str:
    a = arch_id.lower().replace("_", "-")
    if a not in ARCH_IDS:
        # allow python-module style ids like "mamba2_1_3b"
        for k in ARCH_IDS:
            if k.replace("-", "").replace(".", "") == a.replace("-", "").replace(".", ""):
                return k
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return a


def _module(arch_id: str):
    return importlib.import_module(_MODULES[_normalize(arch_id)])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "SUB_QUADRATIC",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "shape_applicable",
    "smoke_shape",
]

"""Config registry: ``get_config(arch_id)`` for every assigned arch — the
port's copy of ``repro/configs/__init__.py``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (InputShape, ModelConfig, SHAPES,
                                      applicable_shapes, reduced)

ARCHS = [
    "phi3-medium-14b", "granite-34b", "deepseek-7b", "minitron-4b",
    "dbrx-132b", "mixtral-8x7b", "whisper-medium", "mamba2-1.3b",
    "llava-next-34b", "jamba-1.5-large-398b",
]

_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "granite-34b": "granite_34b",
    "deepseek-7b": "deepseek_7b",
    "minitron-4b": "minitron_4b",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-medium": "whisper_medium",
    "mamba2-1.3b": "mamba2_13b",
    "llava-next-34b": "llava_next_34b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "InputShape", "ModelConfig",
           "applicable_shapes", "get_config", "reduced"]

"""Architecture registry: the 10 assigned configs + input shapes.

``get_config(name)`` accepts the assigned arch ids (``--arch gemma-2b``);
``reduced_config(name)`` returns the CPU-smoke-test variant of the same
family (≤2 layers, d_model ≤ 512, ≤4 experts).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, InputShape,
                                reduced_shape)

_MODULES = {
    "gemma-2b": "gemma_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "xlstm-350m": "xlstm_350m",
    "starcoder2-7b": "starcoder2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "minitron-4b": "minitron_4b",
    "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = [
    "ARCH_NAMES",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "all_configs",
    "get_config",
    "reduced_config",
    "reduced_shape",
]

"""Architecture registry of the port: every id of the reference's
``ARCH_IDS``, in its order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import MLADims, ModelConfig  # noqa: F401

ARCH_IDS = ["llama-3.2-vision-90b", "llama3.2-3b", "gemma3-27b", "qwen2.5-3b", "granite-3-2b",
            "qwen3-moe-30b-a3b", "mixtral-8x7b", "recurrentgemma-9b", "whisper-base",
            "xlstm-1.3b", "deepseek-v3-mla", "mla-7b"]

_MODULES = {
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "llama3.2-3b": "llama32_3b",
    "gemma3-27b": "gemma3_27b",
    "qwen2.5-3b": "qwen25_3b",
    "granite-3-2b": "granite3_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-base": "whisper_base",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-v3-mla": "deepseek_v3_mla",
    "mla-7b": "mla_7b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()

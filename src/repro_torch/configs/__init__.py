"""Architecture registry of the port (only mla-7b is ported so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import MLADims, ModelConfig  # noqa: F401

ARCH_IDS = ["mla-7b"]

_MODULES = {"mla-7b": "mla_7b"}


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"architecture {arch!r} is not ported yet; "
                         f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()

"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Only the paper's own model is registered so far; the reference's ten other
architectures join as their layers are ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["list_archs", "get_config", "get_smoke_config"]

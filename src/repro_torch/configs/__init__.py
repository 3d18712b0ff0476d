"""Architecture registry: one module per assigned architecture (copies of
``repro.configs``'s, on the port's `ModelConfig`).

``get_config(name)`` returns the full (assignment-exact) ModelConfig;
``get_smoke_config(name)`` a reduced same-family config for CPU tests.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "gemma-7b",
    "qwen3-0.6b",
    "gemma3-12b",
    "qwen3-32b",
    "moonshot-v1-16b-a3b",
    "olmoe-1b-7b",
    "recurrentgemma-2b",
    "musicgen-medium",
    "xlstm-1.3b",
    "llama-3.2-vision-90b",
)

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE

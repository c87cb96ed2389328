"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

A copy of ``repro/configs`` (pure data).  One module per assigned
architecture; each exposes ``config()`` (the exact published sizes) and
``smoke_config()`` (same family, tiny -- used by the CPU tests).  Every
family listed runs in the port: ``models.init_model`` builds each.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec, applicable, shape_by_name

ARCHS: List[str] = [
    "jamba_v01_52b",
    "grok_1_314b",
    "deepseek_v2_lite_16b",
    "qwen25_32b",
    "smollm_135m",
    "yi_6b",
    "qwen3_4b",
    "mamba2_130m",
    "internvl2_2b",
    "whisper_medium",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def _mod(name: str):
    name = _ALIAS.get(name, name)
    return importlib.import_module(f".{name}", __package__)


def get_config(name: str) -> ModelConfig:
    return _mod(name).config().validate()


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke_config().validate()


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "applicable",
           "shape_by_name", "get_config", "get_smoke"]

"""Assigned architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests). ``dili-service``
is the paper's own "architecture": the distributed list service itself.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ArchConfig

ARCH_IDS: List[str] = [
    "qwen2_72b",
    "internlm2_20b",
    "qwen2_0_5b",
    "qwen2_5_3b",
    "musicgen_medium",
    "zamba2_7b",
    "qwen3_moe_235b_a22b",
    "granite_moe_3b_a800m",
    "llava_next_mistral_7b",
    "falcon_mamba_7b",
]

_ALIASES: Dict[str, str] = {
    "qwen2-72b": "qwen2_72b",
    "internlm2-20b": "internlm2_20b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"{__name__}.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"{__name__}.{canonical(name)}")
    return mod.smoke()


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

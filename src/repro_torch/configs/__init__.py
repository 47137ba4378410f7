"""Architecture registry: ``--arch <id>`` → :class:`repro_torch.config.ArchConfig`."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ArchConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-small": "whisper_small",
    "qwen2-1.5b": "qwen2_1_5b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma2-2b": "gemma2_2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-7b": "rwkv6_7b",
    # Paper's own evaluation models (Switch Transformers / NLLB-MoE style)
    "switch-base-128": "switch_base_128",
    "switch-base-256": "switch_base_256",
    "switch-large-128": "switch_large_128",
    "nllb-moe-128": "nllb_moe_128",
}

ARCH_IDS = tuple(_MODULES)
ASSIGNED_ARCHS = ARCH_IDS[:10]


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

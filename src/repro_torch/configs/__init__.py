"""Architecture config registry.

``get_config(arch_id)`` resolves any assigned architecture (plus the
HybridFlow paper's own edge/cloud executor stand-ins) to a ModelConfig.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["ModelConfig", "InputShape", "SHAPES", "ARCH_IDS", "get_config",
           "all_configs", "PAPER_EDGE_ARCH", "PAPER_CLOUD_ARCH",
           "SWAP_EDGE_ARCH", "SWAP_CLOUD_ARCH"]

from repro_torch.configs.base import ModelConfig, InputShape, SHAPES

_MODULES = {
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

ARCH_IDS: List[str] = list(_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _cache:
        return _cache[arch_id]
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = importlib.import_module(_MODULES[arch_id]).CONFIG
    assert cfg.arch_id == arch_id, (cfg.arch_id, arch_id)
    _cache[arch_id] = cfg
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# The HybridFlow paper's own executor pair, mapped onto the assigned pool
# (DESIGN.md §3): edge SLM <- qwen2-1.5b-class model, cloud LLM <- the
# largest assigned executor. Used by examples and the serving engine.
PAPER_EDGE_ARCH = "qwen2-1.5b"
PAPER_CLOUD_ARCH = "mistral-large-123b"
# Model-pair swap experiment (paper App. D.2).
SWAP_EDGE_ARCH = "internlm2-1.8b"
SWAP_CLOUD_ARCH = "mixtral-8x7b"

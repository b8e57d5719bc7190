"""Architectures the port serves, by ``--arch`` id: the dense family and
the MoE family."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama2-7b": "repro_torch.configs.llama2_7b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"the port serves {ALL_ARCHS}, not {arch!r}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG

"""Architectures of the port, by ``--arch`` id: the dense, MoE, SSM,
hybrid, VLM and encoder-decoder families (every arch of the reference
registry)."""
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
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0p1_52b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"the port serves {ALL_ARCHS}, not {arch!r}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG

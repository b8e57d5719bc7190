"""Architecture registry: every arch × input shape the full-size tooling
(``launch/dryrun.py``) walks.

Port of ``repro/configs/registry.py``: the reference's arch lists in its
order, the four input shapes, which combinations are supported and the
per-shape config.  Configs resolve through ``configs/__init__.get_config``.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

__all__ = ["ASSIGNED_ARCHS", "ALL_ARCHS", "get_config", "get_shape",
           "shape_supported", "config_for_shape"]

ALL_ARCHS: List[str] = [
    "starcoder2-15b", "whisper-small", "dbrx-132b", "internvl2-26b",
    "gemma-2b", "yi-6b", "mamba2-2.7b", "olmo-1b", "kimi-k2-1t-a32b",
    "jamba-v0.1-52b",
    "llama2-7b",  # the paper's own backbone
]
ASSIGNED_ARCHS: List[str] = [a for a in ALL_ARCHS if a != "llama2-7b"]


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def shape_supported(arch: str, shape: str) -> bool:
    """Every combination runs but whisper-small × long_500k: an
    encoder-decoder whose decoder context is bounded by its design."""
    return not (arch == "whisper-small" and shape == "long_500k")


def config_for_shape(arch: str, shape: str, smoke: bool = False
                     ) -> ModelConfig:
    """The arch's config for ``shape``: dense, MoE and VLM archs without a
    window take a 4,096-token sliding window at long_500k (the
    sub-quadratic variant), and ``max_seq_len`` grows to the shape's length
    for the 32k and 500k shapes."""
    cfg = get_config(arch, smoke)
    if (shape == "long_500k" and cfg.family in ("dense", "moe", "vlm")
            and cfg.sliding_window == 0):
        cfg = cfg.with_overrides(sliding_window=4096)
    if shape in ("decode_32k", "long_500k", "prefill_32k"):
        need = INPUT_SHAPES[shape].seq_len
        if cfg.max_seq_len < need:
            cfg = cfg.with_overrides(max_seq_len=need)
    return cfg

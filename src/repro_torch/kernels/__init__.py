"""The port's hand-written Hopper kernels and their plain versions.

Importing this package builds nothing and needs no card: the CUDA sources
under ``csrc/`` are compiled on first launch (``kernels/build.py``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.batched_lora import (batched_dual_lora_matmul,
                                              batched_lora_matmul)
from repro_torch.kernels.dual_lora import dual_lora_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention

# every kernel wrapper, by the name its launch counter reports under
WRAPPERS = {
    "paged_attention": paged_attention,
    "paged_prefill_attention": paged_prefill_attention,
    "batched_lora_matmul": batched_lora_matmul,
    "lora_matmul": lora_matmul,
    "flash_attention": flash_attention,
    "dual_lora_matmul": dual_lora_matmul,
    "batched_dual_lora_matmul": batched_dual_lora_matmul,
}

# the kernels of each path of the port
SERVING = ("paged_attention", "paged_prefill_attention", "batched_lora_matmul")
TRAINING = ("lora_matmul", "flash_attention", "dual_lora_matmul")
# kernels no path of the port launches: their entry point is their only
# caller, as in the reference package
STANDALONE = ("batched_dual_lora_matmul",)


# kernels with two tiles, picked by dtype: the tensor-core tile for bf16,
# the CUDA-core tile for fp32 (the LoRA kernels: for bf16 x with bf16 W)
TILES = ("paged_prefill_attention", "flash_attention", "batched_lora_matmul",
         "lora_matmul", "dual_lora_matmul", "batched_dual_lora_matmul")


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def tile_counts() -> Dict[str, Dict[str, int]]:
    """Launches of each two-tile kernel split by tile."""
    return {name: {"mma": WRAPPERS[name].launches_mma,
                   "f32": WRAPPERS[name].launches_f32} for name in TILES}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in TILES:
        WRAPPERS[name].launches_mma = WRAPPERS[name].launches_f32 = 0
    paged_attention.launches_split = paged_attention.launches_combine = 0

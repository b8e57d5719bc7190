"""Model configuration of the PyTorch port (dense decoder family).

The port keeps its own copy of the reference package's ``ModelConfig``,
trimmed to the fields the dense family reads.  ``paged_backend`` (named
for the paged attention it first switched) routes EVERY kernel of the
port, serving and training alike: ``"cuda"`` runs the hand-written Hopper
kernels (paged decode and prefill attention, flash attention, and the
batched, single-tenant and dual LoRA matmuls); ``"torch"`` runs the plain
version of each, the only choice the CPU allows.  ``None`` picks by
device: ``"cuda"`` for tensors on a card, ``"torch"`` on the CPU
(``models/model.py::resolve_backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

PAGED_BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is served by the port so far

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0          # 0 = full attention
    attn_logit_softcap: float = 0.0
    paged_backend: Optional[str] = None   # "torch" | "cuda" | None (by device)

    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    tie_embeddings: bool = False

    max_seq_len: int = 8192

    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_up",
                                     "w_gate", "w_out")

    dtype: str = "bfloat16"          # activations
    param_dtype: str = "bfloat16"    # frozen base weights

    citation: str = ""

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: the port serves the dense family only "
                f"(got {self.family!r})")
        if self.paged_backend not in (None,) + PAGED_BACKENDS:
            raise ValueError(
                f"{self.name}: unknown paged_backend {self.paged_backend!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             "n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def count_params(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * ff
        total = self.n_layers * (attn + mlp + 2 * d) + V * d + d
        if not self.tie_embeddings:
            total += V * d
        return total


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]

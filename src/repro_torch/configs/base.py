"""Model configuration of the PyTorch port (dense and MoE decoders).

The port keeps its own copy of the reference package's ``ModelConfig``,
trimmed to the fields the dense and MoE families read.  A model is
``n_layers`` layers repeating ``layer_pattern``; each entry is
``"<mixer>+<mlp>"``, and the port serves ``"attn+mlp"`` (dense) and
``"attn+moe"`` (top-k routed experts, ``models/moe.py``).
``paged_backend`` (named for the paged attention it first switched)
routes EVERY kernel of the port, serving and training alike: ``"cuda"``
runs the hand-written Hopper kernels (paged decode and prefill attention,
flash attention, and the batched, single-tenant and dual LoRA matmuls);
``"torch"`` runs the plain version of each, the only choice the CPU
allows.  ``None`` picks by device: ``"cuda"`` for tensors on a card,
``"torch"`` on the CPU (``models/model.py::resolve_backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

PAGED_BACKENDS = ("torch", "cuda")
# family -> the layer patterns the port serves for it
SERVED_PATTERNS = {"dense": ("attn+mlp",), "moe": ("attn+moe",)}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" are served by the port so far

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    layer_pattern: Tuple[str, ...] = ("attn+mlp",)

    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0          # 0 = full attention
    attn_logit_softcap: float = 0.0
    paged_backend: Optional[str] = None   # "torch" | "cuda" | None (by device)

    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    d_ff_moe: int = 0                # 0 -> d_ff
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01

    max_seq_len: int = 8192

    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_up",
                                     "w_gate", "w_out")

    dtype: str = "bfloat16"          # activations
    param_dtype: str = "bfloat16"    # frozen base weights

    citation: str = ""

    def __post_init__(self):
        if self.family not in SERVED_PATTERNS:
            raise NotImplementedError(
                f"{self.name}: the port serves the dense and MoE families "
                f"only (got {self.family!r})")
        if tuple(self.layer_pattern) != SERVED_PATTERNS[self.family]:
            raise NotImplementedError(
                f"{self.name}: the port serves the {self.family} family with "
                f"layer_pattern {SERVED_PATTERNS[self.family]}, not "
                f"{tuple(self.layer_pattern)}")
        if self.paged_backend not in (None,) + PAGED_BACKENDS:
            raise ValueError(
                f"{self.name}: unknown paged_backend {self.paged_backend!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             "n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_ff_moe(self) -> int:
        return self.d_ff_moe or self.d_ff

    def has_moe(self) -> bool:
        return any(p.endswith("+moe") for p in self.layer_pattern)

    def layer_entry(self, i: int) -> str:
        """Layer ``i``'s pattern entry (``"attn+mlp"`` or ``"attn+moe"``)."""
        return self.layer_pattern[i % len(self.layer_pattern)]

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def count_params(self) -> int:
        """Base parameters, counted as the reference counts them (the
        final norm left out)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        per = {"attn": (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d),
               "mlp": n_mats * d * ff,
               "moe": (self.n_experts * n_mats * d * self.resolved_d_ff_moe
                       + d * self.n_experts)}
        total = 0
        for i in range(self.n_layers):
            mixer, _, mlp = self.layer_entry(i).partition("+")
            total += per[mixer] + per[mlp] + 2 * d      # + norms
        total += V * d
        if not self.tie_embeddings:
            total += V * d
        return total

    def count_active_params(self) -> int:
        """Parameters a token reads: MoE layers count their routed experts
        only (three matrices an expert, as the reference counts them)."""
        if not self.has_moe():
            return self.count_params()
        d = self.d_model
        moe_full = self.n_experts * 3 * d * self.resolved_d_ff_moe
        moe_active = self.n_experts_per_tok * 3 * d * self.resolved_d_ff_moe
        n_moe = sum(self.layer_entry(i).endswith("+moe")
                    for i in range(self.n_layers))
        return self.count_params() - n_moe * (moe_full - moe_active)


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]

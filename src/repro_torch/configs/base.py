"""Model configuration of the PyTorch port (dense, MoE, SSM, hybrid,
vision-language and encoder-decoder models).

The port keeps its own copy of the reference package's ``ModelConfig``,
trimmed to the fields those families read.  A decoder is ``n_layers``
layers repeating ``layer_pattern``; each entry is ``"<mixer>+<mlp>"``
with the mixer ``"attn"`` or ``"mamba"`` (Mamba2 SSD, ``models/mamba2.py``)
and the MLP ``"mlp"``, ``"moe"`` (top-k routed experts,
``models/moe.py``) or ``"none"``.  The dense family serves ``"attn+mlp"``,
the MoE family ``"attn+moe"``, the SSM family ``"mamba+none"`` and the
hybrid family any pattern of those mixers and MLPs (Jamba's period of 8).
The VLM family is a dense decoder that reads ``n_patch_tokens`` stubbed
image-patch embeddings before the text (``models/model.py``); the
encoder-decoder family (Whisper, ``models/encdec.py``) runs
``n_encoder_layers`` encoder layers over ``encoder_seq_len`` stubbed frame
embeddings and ``n_layers`` decoder layers with cross-attention, both
``"attn+mlp"``.
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
REMAT_POLICIES = ("full", "dots")
VALID_MIXERS = ("attn", "mamba")
VALID_MLPS = ("mlp", "moe", "none")
# family -> the layer patterns the port serves for it (None: any pattern
# of VALID_MIXERS and VALID_MLPS)
SERVED_PATTERNS = {"dense": ("attn+mlp",), "moe": ("attn+moe",),
                   "ssm": ("mamba+none",), "hybrid": None,
                   "vlm": ("attn+mlp",), "encdec": ("attn+mlp",)}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | encdec

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

    # SSM (Mamba2 / SSD)
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 128

    # encoder-decoder (Whisper): the encoder's depth and frame count
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0
    # VLM: stubbed image-patch embeddings prepended to the text
    n_patch_tokens: int = 0

    max_seq_len: int = 8192

    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_up",
                                     "w_gate", "w_out")

    dtype: str = "bfloat16"          # activations
    param_dtype: str = "bfloat16"    # frozen base weights

    # rematerialisation of each period of layers in a train step's forward
    # (``models/model.py::forward``): only the period boundaries are kept,
    # and each period's activations are recomputed in its backward
    remat: bool = True
    # "full" recomputes everything (least memory; a model group's sums are
    # issued again in backward); "dots" saves the outputs of the products
    # without batch dims (the projections) and recomputes the rest
    remat_policy: str = "full"

    citation: str = ""

    def __post_init__(self):
        if self.family not in SERVED_PATTERNS:
            raise NotImplementedError(
                f"{self.name}: the port serves the {sorted(SERVED_PATTERNS)} "
                f"families only (got {self.family!r})")
        served = SERVED_PATTERNS[self.family]
        if served is None:
            for p in self.layer_pattern:
                mixer, _, mlp = p.partition("+")
                if mixer not in VALID_MIXERS or mlp not in VALID_MLPS:
                    raise NotImplementedError(
                        f"{self.name}: layer pattern entry {p!r} is not "
                        f"<{'|'.join(VALID_MIXERS)}>+<"
                        f"{'|'.join(VALID_MLPS)}>")
        elif tuple(self.layer_pattern) != served:
            raise NotImplementedError(
                f"{self.name}: the port serves the {self.family} family with "
                f"layer_pattern {SERVED_PATTERNS[self.family]}, not "
                f"{tuple(self.layer_pattern)}")
        if self.paged_backend not in (None,) + PAGED_BACKENDS:
            raise ValueError(
                f"{self.name}: unknown paged_backend {self.paged_backend!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"{self.name}: unknown remat_policy "
                             f"{self.remat_policy!r}; one of "
                             f"{REMAT_POLICIES}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             "n_kv_heads")
        if self.n_layers % len(self.layer_pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not a "
                             "multiple of the pattern period "
                             f"{len(self.layer_pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_ff_moe(self) -> int:
        return self.d_ff_moe or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def has_mixer(self, mixer: str) -> bool:
        return any(p.startswith(mixer + "+") or p == mixer
                   for p in self.layer_pattern)

    def has_moe(self) -> bool:
        return any(p.endswith("+moe") for p in self.layer_pattern)

    def layer_entry(self, i: int) -> str:
        """Layer ``i``'s pattern entry (``"attn+mlp"``, ``"mamba+moe"``,
        ...)."""
        return self.layer_pattern[i % len(self.layer_pattern)]

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def count_params(self) -> int:
        """Base parameters, counted as the reference counts them (the
        final norm left out, two norms a layer even where an ``"+none"``
        layer has one, a mamba layer's per-head vectors counted twice and
        its gated norm's scale not at all; an encoder-decoder adds its
        encoder layers, a cross-attention per ENCODER layer with one norm,
        and learned positions at ``encoder_seq_len`` and
        ``max_seq_len``)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        d_in, n_h = self.ssm_d_inner, self.ssm_n_heads
        bc = 2 * self.ssm_n_groups * self.ssm_d_state
        per = {"attn": (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d),
               "mamba": (d * (2 * d_in + bc + n_h) + d_in * d
                         + self.ssm_d_conv * (d_in + bc) + 2 * n_h),
               "mlp": n_mats * d * ff,
               "moe": (self.n_experts * n_mats * d * self.resolved_d_ff_moe
                       + d * self.n_experts),
               "none": 0}
        total = 0
        for i in range(self.n_layers):
            mixer, _, mlp = self.layer_entry(i).partition("+")
            total += per[mixer] + per[mlp] + 2 * d      # + norms
        total += V * d
        if not self.tie_embeddings:
            total += V * d
        if self.is_encdec:
            enc_layer = per["attn"] + per["mlp"] + 2 * d
            total += self.n_encoder_layers * (enc_layer + per["attn"] + d)
            total += self.encoder_seq_len * d + self.max_seq_len * d
        return total

    def count_lora_params(self, rank: Optional[int] = None) -> int:
        """Trainable parameters of one adapter tree at ``rank``."""
        from repro_torch.core.lora import lora_target_shapes
        r = rank or self.lora_rank
        return sum(din * r + r * dout
                   for din, dout in lora_target_shapes(self))

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


# ---------------------------------------------------------------------------
# Input shapes: name -> (seq_len, global_batch, kind), the reference's four
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

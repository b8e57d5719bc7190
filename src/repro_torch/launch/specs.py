"""Meta-tensor stand-ins for every model input of the dry run.

Port of the input halves of ``repro/launch/specs.py``: ``train_inputs``
and ``decode_inputs`` give the reference's keys, shapes and dtypes as
tensors on ``torch.device("meta")`` (no memory, no values).  The
sharding halves (``batch_axes``, ``*_input_specs``, ``sharding_tree``,
``pad_spec_to``) wait for the port's mesh.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """A train or prefill batch at the shape's global batch and length:
    :func:`batch_inputs`."""
    sh = INPUT_SHAPES[shape_name]
    return batch_inputs(cfg, sh.global_batch, sh.seq_len)


def batch_inputs(cfg: ModelConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    """``tokens`` and ``loss_mask`` (B, S) int32, the VLM's
    ``patch_embeds`` (B, n_patch_tokens, d) and the encoder-decoder's
    ``enc_embeds`` (B, encoder_seq_len, d), bf16."""
    out = {"tokens": _meta((B, S), torch.int32),
           "loss_mask": _meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((B, cfg.n_patch_tokens, cfg.d_model),
                                    torch.bfloat16)
    if cfg.is_encdec:
        out["enc_embeds"] = _meta((B, cfg.encoder_seq_len, cfg.d_model),
                                  torch.bfloat16)
    return out


def decode_inputs(cfg: ModelConfig, shape_name: str
                  ) -> Dict[str, torch.Tensor]:
    """One decode step: ``tokens`` (B, 1) int32 and ``pos`` a 0-d int32."""
    return step_inputs(INPUT_SHAPES[shape_name].global_batch)


def step_inputs(B: int) -> Dict[str, torch.Tensor]:
    """:func:`decode_inputs` at B rows."""
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}

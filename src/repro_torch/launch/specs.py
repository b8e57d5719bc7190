"""Meta-tensor stand-ins for every model input, and their shardings.

Port of ``repro/launch/specs.py``.  ``train_inputs`` and
``decode_inputs`` give the reference's keys, shapes and dtypes as
tensors on ``torch.device("meta")`` (no memory, no values), and
``abstract_tree`` runs any function there.  The sharding half gives
partition specs (``core/partition.P``): batch dims over ("pod", "data") when
their product divides the batch, "data" when only that divides, else
replicated (long_500k has a global batch of 1).  ``sharding_tree`` fits a
spec tree to a mesh.  Each reads only the mesh's axis names and sizes
(``core/partition.mesh_shape``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.core.partition import P, entry_axes, mesh_shape, spec_map


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


def batch_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ("pod", "data") whose product divides the batch."""
    sizes = mesh_shape(mesh)
    chosen, prod = [], 1
    for n in ("pod", "data"):
        if n in sizes and global_batch % (prod * sizes[n]) == 0:
            chosen.append(n)
            prod *= sizes[n]
    return tuple(chosen) or None


def train_input_specs(cfg: ModelConfig, mesh, shape_name: str
                      ) -> Dict[str, P]:
    ba = batch_axes(mesh, INPUT_SHAPES[shape_name].global_batch)
    specs = {"tokens": P(ba, None), "loss_mask": P(ba, None)}
    if cfg.family == "vlm":
        specs["patch_embeds"] = P(ba, None, None)
    if cfg.is_encdec:
        specs["enc_embeds"] = P(ba, None, None)
    return specs


def decode_input_specs(cfg: ModelConfig, mesh, shape_name: str
                       ) -> Dict[str, P]:
    ba = batch_axes(mesh, INPUT_SHAPES[shape_name].global_batch)
    return {"tokens": P(ba, None), "pos": P()}


def abstract_tree(fn, *args, **kw):
    """Shapes and dtypes of ``fn(*args, **kw)`` without running it: the
    call under ``torch.device("meta")``, its tensors created there (the
    arguments should be meta tensors too)."""
    with torch.device("meta"):
        return fn(*args, **kw)


def sharding_tree(mesh, spec_tree, shape_tree=None):
    """A spec tree fitted to ``mesh``: axes the mesh lacks are dropped
    and, given the leaves (``shape_tree``: anything with ``.shape``), an
    entry whose axes' product does not divide its dim is replicated."""
    sizes = mesh_shape(mesh)

    def fix(spec, *leaf):
        entries = []
        for d, e in enumerate(spec):
            kept = tuple(n for n in entry_axes(e) if n in sizes)
            if leaf and kept:
                n = 1
                for a in kept:
                    n *= sizes[a]
                if leaf[0].shape[d] % n:
                    kept = ()
            entries.append(kept if len(kept) > 1
                           else (kept[0] if kept else None))
        return P(*entries)

    if shape_tree is None:
        return spec_map(fix, spec_tree)
    return spec_map(fix, spec_tree, shape_tree)


def pad_spec_to(spec_tree, shape_tree):
    """Every spec at exactly its leaf's rank (padded with None, or cut)."""
    def fix(spec, leaf):
        rank = len(leaf.shape)
        t = tuple(spec)
        return P(*(t + (None,) * (rank - len(t)))[:rank])

    return spec_map(fix, spec_tree, shape_tree)

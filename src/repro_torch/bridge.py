"""Weight bridge from the reference package's pytrees to the port's trees.

The reference stacks every layer leaf on a leading period axis (params
``blocks/b<j>/...`` of shape ``(n_periods, ...)``; adapter banks
``(n_periods, C, d_in, r)``; decode caches, SSM state included).  Each
leaf keeps its dtype, so a mamba layer's fp32 ``a_log``, ``dt_bias``,
``d_skip`` and ``norm_scale`` stay fp32 in a bf16 model.  The port keeps one dict per layer.  These
functions take the reference trees AS NUMPY ARRAYS (``np.asarray`` on each
leaf; bfloat16 arrays are accepted) and return torch trees, so both
packages compute on the same weights.  Nothing here imports the reference
package: the trees are plain nested dicts.  Like every entry point of the
port they put their tensors on the card unless the caller asks for the
CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]


def to_torch(x, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor (bfloat16 goes through float32, exactly)."""
    device = resolve_device(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _period_slice(leaf, p: int, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf[p].to(device).clone()
    return to_torch(np.asarray(leaf)[p], device)


def unstack_blocks(blocks: Params, device="cuda") -> list:
    """``{"b0": tree, "b1": tree, ...}`` with leaves (n_periods, ...) (numpy
    or torch) -> per-layer trees: layer ``p * period + j`` is period p of
    block j."""
    device = resolve_device(device)
    names = sorted(blocks, key=lambda n: int(n[1:]))
    period = len(names)
    layers = []
    for i in range(_n_layers(blocks)):
        p, j = divmod(i, period)
        layers.append(_map(lambda leaf: _period_slice(leaf, p, device),
                           blocks[names[j]]))
    return layers


def _n_layers(blocks: Params) -> int:
    def first_leaf(t):
        while isinstance(t, dict):
            t = next(iter(t.values()))
        return t
    return len(blocks) * int(first_leaf(blocks).shape[0])


def params_from_jax(tree: Params, device="cuda") -> Params:
    """Reference ``init_params`` tree (numpy leaves) -> port params.  The
    encoder-decoder's tree (``embed``, ``enc_pos``, ``dec_pos``,
    ``enc_blocks``, ``dec_blocks``, two final norms) keeps its layout,
    leaves stacked over depth, as ``models/encdec.py`` reads it."""
    if "enc_blocks" in tree:
        return _map(lambda l: to_torch(l, device), tree)
    out = {"embed": to_torch(tree["embed"], device),
           "final_norm": _map(lambda l: to_torch(l, device),
                              tree["final_norm"]),
           "layers": unstack_blocks(tree["blocks"], device)}
    if "lm_head" in tree:
        out["lm_head"] = to_torch(tree["lm_head"], device)
    return out


def adapters_from_jax(tree: Params, device="cuda") -> Params:
    """Reference adapter tree or registry bank, or decode cache (numpy
    leaves, stacked on the period axis: K/V pools or ring buffers, SSM
    state ``h`` (n_periods, rows, H, P, N) and ``conv`` (n_periods, rows,
    K-1, conv_dim)) -> port tree ``{"layers": [...]}`` with the same
    dtypes (a ring buffer's write count is not carried).  The
    encoder-decoder's adapter tree (``enc_blocks``/``dec_blocks``) keeps
    its stacked layout; its decode cache (``self``, ``cross_k``,
    ``cross_v``) too, the ring buffers' write count carried as one int."""
    if "enc_blocks" in tree:
        return _map(lambda l: to_torch(l, device), tree)
    if "cross_k" in tree:
        ring = tree["self"]
        return {"self": {"k": to_torch(ring["k"], device),
                         "v": to_torch(ring["v"], device),
                         "pos": int(np.asarray(ring["pos"]).reshape(-1)[0])},
                "cross_k": to_torch(tree["cross_k"], device),
                "cross_v": to_torch(tree["cross_v"], device)}
    return {"layers": unstack_blocks(tree["blocks"], device)}


def config_from_jax(cfg, **overrides):
    """The port's ``ModelConfig`` with the fields of a reference config
    (read by attribute; the backend switch is the port's own)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name != "paged_backend" and hasattr(cfg, f.name)}
    kw.update(overrides)
    return ModelConfig(**kw)

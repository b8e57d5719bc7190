"""LoRA adapters (Hu et al. 2021) as per-layer parameter trees.

An adapter tree is ``{"layers": [layer_0, layer_1, ...]}`` where each layer
holds, at each targeted linear, ``{"a": A (d_in, r), "b": B (r, d_out)}``
under ``"mixer"`` (attention) or ``"mlp"``.  The reference package stacks
the same leaves on a leading period axis for its ``lax.scan``; the port
loops over layers in Python, so it keeps one entry per layer
(``repro_torch.bridge`` converts between the two).

The update is ``(alpha / r) · (x @ A) @ B`` added to the frozen base
output; ``B`` starts at zero so a fresh adapter is the base model.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

Params = Dict[str, Any]


def block_target_shapes(cfg, entry: str = "attn+mlp"
                        ) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """``{"mixer": {...}, "mlp": {...}}`` target -> (d_in, d_out) for one
    layer of pattern ``entry``.  Attention and the dense MLP are filtered
    by ``cfg.lora_targets``; an ``"attn+moe"`` layer's ``mlp`` holds the
    router's pair (d, E) whatever ``lora_targets`` says (per-expert
    adapters would defeat PEFT), as in the reference."""
    d, H, Kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    sel = set(cfg.lora_targets)
    attn = {"wq": (d, H * hd), "wk": (d, Kv * hd), "wv": (d, Kv * hd),
            "wo": (H * hd, d)}
    mlp = {"w_up": (d, ff), "w_out": (ff, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp["w_gate"] = (d, ff)
    out = {}
    for part, targets in (("mixer", attn), ("mlp", mlp)):
        t = {k: v for k, v in targets.items() if k in sel}
        if t:
            out[part] = t
    if entry.endswith("+moe"):
        out["mlp"] = {"router": (d, cfg.n_experts)}
    return out


def init_adapters(cfg, rank: Optional[int] = None, seed: int = 0,
                  device="cuda", b_std: float = 0.0) -> Params:
    """A fresh adapter tree on ``device`` (the card unless the caller asks
    for the CPU): ``A ~ N(0, 1) / r`` from a numpy generator seeded with
    ``seed``; ``B`` is zero (standard LoRA init) unless ``b_std > 0`` draws
    it ``N(0, b_std²)``: the serving and training checks want a non-zero
    update so a fault in the LoRA path cannot hide."""
    device = resolve_device(device)
    r = rank or cfg.lora_rank
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(cfg.n_layers):
        layer = {}
        for part, tmap in block_target_shapes(cfg, cfg.layer_entry(i)).items():
            layer[part] = {}
            for t, (din, dout) in tmap.items():
                a = rng.standard_normal((din, r), np.float32) / r
                b = (rng.standard_normal((r, dout), np.float32) * b_std
                     if b_std > 0 else np.zeros((r, dout), np.float32))
                layer[part][t] = {"a": torch.from_numpy(a).to(device),
                                  "b": torch.from_numpy(b).to(device)}
        layers.append(layer)
    return {"layers": layers}


def lora_scale(cfg, rank: Optional[int] = None) -> float:
    return cfg.lora_alpha / float(rank or cfg.lora_rank)


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over trees of dicts/lists with equal structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree, path: str = ""):
    """``[(path, leaf), ...]`` in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                tree_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                tree_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# Tree arithmetic (used by the optimizers, the federated outer step and
# fusion)
# ---------------------------------------------------------------------------

def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_mean(trees):
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b):
    """Sum over leaves of ``<a_leaf, b_leaf>``: a 0-d tensor."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)))


def tree_norm(a):
    """Global L2 norm over every leaf, in fp32: a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(a)))

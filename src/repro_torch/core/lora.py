"""LoRA adapters (Hu et al. 2021) as per-layer parameter trees.

An adapter tree is ``{"layers": [layer_0, layer_1, ...]}`` where each layer
holds, at each targeted linear, ``{"a": A (d_in, r), "b": B (r, d_out)}``
under ``"mixer"`` (attention, or a mamba block's projections) or
``"mlp"``.  The reference package stacks
the same leaves on a leading period axis for its ``lax.scan``; the port
loops over layers in Python, so it keeps one entry per layer
(``repro_torch.bridge`` converts between the two).  The encoder-decoder's
tree is the reference's: ``{"enc_blocks": {"self_attn", "mlp"},
"dec_blocks": {"self_attn", "cross_attn", "mlp"}}``, each target's leaves
stacked over its own depth (A (L, d_in, r), B (L, r, d_out)), as
``models/encdec.py`` stacks its weights.

The update is ``(alpha / r) · (x @ A) @ B`` added to the frozen base
output; ``B`` starts at zero so a fresh adapter is the base model.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.partition import P

Params = Dict[str, Any]


def block_target_shapes(cfg, entry: str = "attn+mlp"
                        ) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """``{"mixer": {...}, "mlp": {...}}`` target -> (d_in, d_out) for one
    layer of pattern ``entry``, as the reference's.  Attention and the
    dense MLP are filtered by ``cfg.lora_targets``; a mamba mixer always
    holds ``in_proj`` and ``out_proj``, and a ``"+moe"`` layer's ``mlp``
    the router's pair (d, E), whatever ``lora_targets`` says (per-expert
    adapters would defeat PEFT).  So Jamba's mamba layers carry adapters
    though its ``lora_targets`` name only attention and MLP weights."""
    d, H, Kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    sel = set(cfg.lora_targets)
    mixer, _, mlp_kind = entry.partition("+")
    out = {}
    if mixer == "attn":
        t = {k: v for k, v in {"wq": (d, H * hd), "wk": (d, Kv * hd),
                               "wv": (d, Kv * hd),
                               "wo": (H * hd, d)}.items() if k in sel}
    else:
        from repro_torch.models.mamba2 import _dims
        d_in, _, _, _, _, proj_dim = _dims(cfg)
        t = {"in_proj": (d, proj_dim), "out_proj": (d_in, d)}
    if t:
        out["mixer"] = t
    if mlp_kind == "mlp":
        mlp = {"w_up": (d, ff), "w_out": (ff, d)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            mlp["w_gate"] = (d, ff)
        t = {k: v for k, v in mlp.items() if k in sel}
        if t:
            out["mlp"] = t
    elif mlp_kind == "moe":
        out["mlp"] = {"router": (d, cfg.n_experts)}
    return out


def _attn_mlp_targets(cfg):
    """The encoder-decoder's attention and MLP targets, filtered by
    ``cfg.lora_targets``: ({name: (d_in, d_out)}, {name: (d_in, d_out)})."""
    t = block_target_shapes(cfg, "attn+mlp")
    return t.get("mixer", {}), t.get("mlp", {})


def lora_target_shapes(cfg) -> List[Tuple[int, int]]:
    """Every adapted (d_in, d_out) over the whole depth, as the reference
    lists them for its parameter count.  The encoder-decoder counts its
    attention targets over the encoder's layers and twice over the
    decoder's (self- and cross-attention), the MLP's once per layer."""
    if cfg.is_encdec:
        at, mt = _attn_mlp_targets(cfg)
        return (list(at.values()) * (cfg.n_encoder_layers + 2 * cfg.n_layers)
                + list(mt.values()) * (cfg.n_encoder_layers + cfg.n_layers))
    return [kn for i in range(cfg.n_layers)
            for part in block_target_shapes(cfg, cfg.layer_entry(i)).values()
            for kn in part.values()]


def init_adapters(cfg, rank: Optional[int] = None, seed: int = 0,
                  device="cuda", b_std: float = 0.0) -> Params:
    """A fresh adapter tree on ``device`` (the card unless the caller asks
    for the CPU): ``A ~ N(0, 1) / r`` from a numpy generator seeded with
    ``seed``; ``B`` is zero (standard LoRA init) unless ``b_std > 0`` draws
    it ``N(0, b_std²)``: the serving and training checks want a non-zero
    update so a fault in the LoRA path cannot hide.  On the meta device
    the tree has the same shapes and dtypes and no values."""
    device = resolve_device(device)
    r = rank or cfg.lora_rank
    rng = np.random.default_rng(seed)

    def pairs(tmap, *lead):
        out = {}
        for t, (din, dout) in tmap.items():
            if device.type == "meta":
                out[t] = {"a": torch.empty((*lead, din, r), device=device),
                          "b": torch.empty((*lead, r, dout), device=device)}
                continue
            a = rng.standard_normal((*lead, din, r), np.float32) / r
            b = (rng.standard_normal((*lead, r, dout), np.float32) * b_std
                 if b_std > 0 else np.zeros((*lead, r, dout), np.float32))
            out[t] = {"a": torch.from_numpy(a).to(device),
                      "b": torch.from_numpy(b).to(device)}
        return out

    if cfg.is_encdec:
        at, mt = _attn_mlp_targets(cfg)
        Le, Ld = cfg.n_encoder_layers, cfg.n_layers
        return {"enc_blocks": {"self_attn": pairs(at, Le),
                               "mlp": pairs(mt, Le)},
                "dec_blocks": {"self_attn": pairs(at, Ld),
                               "cross_attn": pairs(at, Ld),
                               "mlp": pairs(mt, Ld)}}
    return {"layers": [
        {part: pairs(tmap) for part, tmap in
         block_target_shapes(cfg, cfg.layer_entry(i)).items()}
        for i in range(cfg.n_layers)]}


def adapter_specs(cfg, base_specs: Optional[Params] = None) -> Params:
    """Partition specs (``core/partition.P``) of :func:`init_adapters`'s
    tree, the reference's rule: A takes the base weight's input-dim sharding,
    B its output-dim sharding; the rank dim is never split.  The base
    keeps d_model replicated and splits head and ff dims on ``"model"``,
    so B's output dim is on ``"model"`` for wq/wk/wv/w_up/w_gate/in_proj
    and A's input dim for wo/w_out/out_proj (``in_proj``'s B by heads
    within each segment of its columns, ``tensor_parallel.Segments``;
    ``tensor_parallel.replicated`` names the columns every rank holds
    whole); everything else is replicated.  A stacked (encoder-decoder)
    leaf has a replicated depth entry first.  ``base_specs`` is accepted and unused, as in the
    reference."""
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.models.mamba2 import in_proj_segments
    sharded_out = {"wq", "wk", "wv", "w_up", "w_gate", "in_proj"}
    sharded_in = {"wo", "w_out", "out_proj"}

    def walk(tree, name=None):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if set(tree) == {"a", "b"}:
            lead = (None,) * (tree["a"].dim() - 2)
            out = "model" if name in sharded_out else None
            if name == "in_proj":       # its columns cut by heads a segment
                out = tpl.Segments("model", in_proj_segments(cfg))
            return {"a": P(*lead, "model" if name in sharded_in else None,
                           None),
                    "b": P(*lead, None, out)}
        return {k: walk(v, k) for k, v in tree.items()}

    return walk(init_adapters(cfg, device="meta"))


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


def tree_flatten(tree, dtype=None) -> torch.Tensor:
    """Every leaf of ``tree`` in :func:`tree_leaves` order, in one 1-D
    tensor (of ``dtype``, or the leaves' own)."""
    return torch.cat([t.reshape(-1).to(dtype or t.dtype)
                      for _, t in tree_leaves(tree)])


def tree_unflatten(flat: torch.Tensor, like):
    """The inverse of :func:`tree_flatten`: ``like``'s tree with each leaf
    a view of its span of ``flat``, shaped as ``like``'s leaf."""
    off = 0

    def walk(t):
        nonlocal off
        if isinstance(t, dict):
            vals = {k: walk(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        out = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        return out

    return walk(like)


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

"""Dual-LoRA state and the Eq. 7 adaptive merge of FDLoRA's dual adapters.

Each client holds a personalized tree (θ_p, never leaves the client) and
the federated global tree (θ_s) over the same frozen base
(:class:`DualLoRAState`).  AdaFusion merges them per factor:

    m̂ = (w1·A1 + w2·A2) @ (w1·B1 + w2·B2)                          (Eq. 7)

which needs equal ranks and yields one standard adapter, served by the
same path as any single-LoRA client.  :func:`fused_forward` runs the
model through the merge: on ``"torch"`` it merges, then runs the plain
forward, as the reference does; on ``"cuda"`` each projection takes both
pairs and the weights (:func:`dual_tree`) and the dual-LoRA kernel merges
on the chip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.lora import tree_leaves, tree_map
from repro_torch.models.model import resolve_backend

Params = Dict[str, Any]


@dataclasses.dataclass
class DualLoRAState:
    """One client's two adapter trees and its fusion weights
    ``[w1 (personalized), w2 (global)]``, (2,) fp32."""
    personalized: Params
    global_: Params
    fusion_weights: torch.Tensor

    def replace(self, **kw) -> "DualLoRAState":
        return dataclasses.replace(self, **kw)


def _is_pair(node) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b"}


def _a_leaves(tree) -> list:
    """The ``a`` factor of every ``{"a", "b"}`` target in ``tree``."""
    if _is_pair(tree):
        return [tree["a"]]
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _a_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _a_leaves(v)]
    return []


def check_same_rank(ad1: Params, ad2: Params) -> None:
    """Fail unless both trees hold the same set of ranks (the reference's
    coarse check; :func:`check_rank_agreement` names the target)."""
    r1 = {a.shape[-1] for a in _a_leaves(ad1)}
    r2 = {a.shape[-1] for a in _a_leaves(ad2)}
    if r1 != r2:
        raise ValueError(f"AdaFusion requires equal LoRA rank, got {r1} vs {r2}")


def check_rank_agreement(personalized: Params, global_: Params) -> None:
    """Fail at the first ``{"a", "b"}`` target whose two ranks differ,
    naming it (a plain leafwise merge would broadcast or die opaquely)."""
    def walk(p, g, path):
        if _is_pair(p) and _is_pair(g):
            rp, rg = p["a"].shape[-1], g["a"].shape[-1]
            if rp != rg:
                raise ValueError(
                    f"AdaFusion (Eq. 7) requires equal LoRA rank per target; "
                    f"leaf {path or '<root>'} has personalized rank {rp} vs "
                    f"global rank {rg}")
            return
        if isinstance(p, dict) and isinstance(g, dict):
            for k in p:
                if k in g:
                    walk(p[k], g[k], f"{path}[{k!r}]")
        elif isinstance(p, (list, tuple)) and isinstance(g, (list, tuple)):
            for i, (pi, gi) in enumerate(zip(p, g)):
                walk(pi, gi, f"{path}[{i}]")
    walk(personalized, global_, "")


def merge(personalized: Params, global_: Params, w) -> Params:
    """Eq. 7: leafwise ``w1 * θ_p + w2 * θ_s`` with ``w = [w1, w2]``."""
    w1, w2 = float(w[0]), float(w[1])
    return tree_map(lambda p, g: w1 * p + w2 * g, personalized, global_)


def dual_tree(personalized: Params, global_: Params, w) -> Params:
    """Both trees and the fusion weights, unmerged, for the fused-kernel
    path: every ``{"a", "b"}`` target becomes ``{"a": A1, "b": B1, "a2": A2,
    "b2": B2, "w": w}`` with ``w`` (2,) fp32 on the adapters' device, so a
    projection computes Eq. 7 itself (``layers.DualPair``) and the merged
    factors are never stored."""
    check_rank_agreement(personalized, global_)
    dev = tree_leaves(personalized)[0][1].device
    wt = torch.as_tensor(w, dtype=torch.float32).to(dev)

    def walk(p, g):
        if _is_pair(p):
            return {"a": p["a"], "b": p["b"], "a2": g["a"], "b2": g["b"],
                    "w": wt}
        if isinstance(p, dict):
            return {k: walk(p[k], g[k]) for k in p}
        return [walk(pi, gi) for pi, gi in zip(p, g)]
    return walk(personalized, global_)


def fused_forward(model, params: Params, batch, state: DualLoRAState,
                  lora_scale: float, paged_backend: Optional[str] = None):
    """The forward through the base and the Eq. 7 merge of ``state``'s
    trees at its fusion weights: ``(logits, aux)`` as ``Model.forward``
    returns them.  ``paged_backend`` as everywhere in the port (``None``:
    by device; the CPU refuses ``"cuda"``)."""
    backend = resolve_backend(model.cfg, paged_backend,
                              model.device).paged_backend
    if backend == "cuda":
        adapters = dual_tree(state.personalized, state.global_,
                             state.fusion_weights)
    else:
        adapters = merge(state.personalized, state.global_,
                         state.fusion_weights)
    return model.forward(params, batch, adapters=adapters,
                         lora_scale=lora_scale, paged_backend=backend)

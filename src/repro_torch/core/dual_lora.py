"""The Eq. 7 adaptive merge of FDLoRA's dual adapters.

Each client holds a personalized tree (θ_p) and the federated global tree
(θ_s) over the same frozen base.  AdaFusion merges them per factor:

    m̂ = (w1·A1 + w2·A2) @ (w1·B1 + w2·B2)                          (Eq. 7)

which needs equal ranks and yields one standard adapter, served by the
same path as any single-LoRA client.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.lora import tree_leaves, tree_map

Params = Dict[str, Any]


def _is_pair(node) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b"}


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

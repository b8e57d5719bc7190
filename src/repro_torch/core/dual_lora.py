"""The Eq. 7 adaptive merge of FDLoRA's dual adapters.

Each client holds a personalized tree (θ_p) and the federated global tree
(θ_s) over the same frozen base.  AdaFusion merges them per factor:

    m̂ = (w1·A1 + w2·A2) @ (w1·B1 + w2·B2)                          (Eq. 7)

which needs equal ranks and yields one standard adapter, served by the
same path as any single-LoRA client.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.lora import tree_map

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

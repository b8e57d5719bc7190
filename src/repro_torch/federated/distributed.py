"""One FDLoRA round over client-stacked state.

Port of ``repro/federated/distributed.py::make_fdlora_round_step``: one
federated round (K inner AdamW steps per client, then the server's outer
step) as one function over state stacked on a leading client axis:

    adapters / inner optimizer state:  (N_clients, ...)
    batches:                           (N_clients, K, B, S)

The reference maps the clients with ``jax.vmap`` and lets the mesh place
them, one client per pod.  The card is one device, so the port runs at
world size 1: the clients run one after another in a Python loop over the
client axis (the kernels launch through ctypes, which ``torch.func.vmap``
cannot map).  The outer pseudo-gradient mean over the client axis is the
reference's only cross-pod reduction; here it is a mean over a stacked
tensor.  The multi-device specs (``client_stacked_specs``, ``batch_specs``)
wait for the port's mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.lora import tree_map
from repro_torch.training.optimizers import (Optimizer, apply_updates,
                                             clip_by_global_norm)
from repro_torch.training.train_step import make_lora_loss_fn, value_and_grad

Params = Any


def stack_clients(trees: Sequence[Any]) -> Any:
    """Per-client trees (adapters or optimizer states) -> one tree stacked
    on a leading client axis.  Tensor leaves stack; host integers (AdamW's
    step count) become a numpy array (N,)."""
    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.asarray(leaves)
    return tree_map(stack, *trees)


def client_slice(tree: Any, i: int) -> Any:
    """Client ``i`` of a stacked tree (the inverse of :func:`stack_clients`)."""
    def take(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf[i]
        return int(leaf[i])
    return tree_map(take, tree)


def make_fdlora_round_step(model, cfg, inner_opt: Optimizer,
                           outer_opt: Optimizer, inner_steps: int,
                           sync_personalized: bool = False,
                           compress_outer: str = "none") -> Callable:
    """Returns round(base, theta_s, stacked_state, batches) -> (theta_s',
    state', loss).

    stacked_state = {"inner_opt": (N, ...), "outer_opt": {...}, and
    "personalized" (N, ...) when ``sync_personalized``}; batches: dict of
    (N, K, B, S) tensors.  The pseudo-gradient θ_s − mean_i θ_i is shipped
    in fp32, or in bf16 under ``compress_outer="bf16"`` (the mean over
    clients reads bf16 operands; the outer step itself stays fp32).
    ``loss`` is the mean over clients of each client's mean over its K
    steps (a device scalar).  The kernels follow the model's device and
    config (``"cuda"`` on a card).
    """
    if compress_outer not in ("none", "bf16"):
        raise ValueError(f"unknown compress_outer {compress_outer!r}")
    vg = value_and_grad(make_lora_loss_fn(model, cfg))

    def one_client(base, theta_s, inner_state, batches_k):
        """K inner AdamW steps on this client's copy of the global LoRA."""
        ad, st = theta_s, inner_state
        losses: List[torch.Tensor] = []
        for k in range(inner_steps):
            _, m, grads = vg(ad, base, {n: v[k] for n, v in batches_k.items()})
            grads = clip_by_global_norm(grads, 1.0)
            upd, st = inner_opt.update(grads, st, ad)
            ad = apply_updates(ad, upd)
            losses.append(m["loss"])
        return ad, st, torch.stack(losses).mean()

    def round_step(base, theta_s, state: Dict, batches: Dict):
        # -- inner phase: clients independent, one after another ------------
        n_clients = next(iter(batches.values())).shape[0]
        thetas, states, losses = [], [], []
        for i in range(n_clients):
            th, st, loss = one_client(
                base, theta_s, client_slice(state["inner_opt"], i),
                {n: v[i] for n, v in batches.items()})
            thetas.append(th)
            states.append(st)
            losses.append(loss)
        theta_i = stack_clients(thetas)
        # -- outer phase: the pseudo-gradient over the client axis ----------
        if compress_outer == "bf16":
            delta = tree_map(
                lambda prev, ti: (prev[None] - ti).to(torch.bfloat16)
                .mean(dim=0).float(), theta_s, theta_i)
        else:
            delta = tree_map(lambda prev, ti: prev - ti.mean(dim=0),
                             theta_s, theta_i)
        upd, outer_state = outer_opt.update(delta, state["outer_opt"], theta_s)
        theta_s_new = apply_updates(theta_s, upd)
        new_state = dict(state, inner_opt=stack_clients(states),
                         outer_opt=outer_state)
        if sync_personalized:  # Algorithm 1 lines 13-15 (H-round sync)
            new_state["personalized"] = theta_i
        return theta_s_new, new_state, torch.stack(losses).mean()

    return round_step

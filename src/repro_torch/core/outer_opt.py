"""Outer (server-side) optimization of the federated stage.

Port of ``repro/core/outer_opt.py``.  Algorithm 1, lines 17-18: the server
averages the clients' pseudo-gradients ``Δ = (1/N) Σ_i (θ_s − θ_s^(i))``
and applies OuterOpt: Nesterov momentum in the paper; SGD with lr 1 is
FedAvg.
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch.core.lora import tree_mean, tree_sub
from repro_torch.training.optimizers import Optimizer, apply_updates, sgd

Params = Any


def pseudo_gradient(theta_prev: Params,
                    client_thetas: Sequence[Params]) -> Params:
    """Δ = mean_i (θ_prev − θ_i): points from the clients' average."""
    return tree_sub(theta_prev, tree_mean(list(client_thetas)))


def make_outer_optimizer(kind: str = "nesterov", lr: float = 1e-3,
                         momentum: float = 0.5) -> Optimizer:
    if kind == "nesterov":
        return sgd(lr=lr, momentum=momentum, nesterov=True)
    if kind == "sgd":
        return sgd(lr=lr, momentum=0.0)
    if kind == "fedavg":
        # θ ← θ − 1·Δ is the mean of the client trees: FedAvg
        return sgd(lr=1.0, momentum=0.0)
    raise ValueError(kind)


def outer_step(opt: Optimizer, theta_prev: Params, opt_state,
               client_thetas: Sequence[Params]):
    """One server round; returns (theta_new, opt_state, delta)."""
    delta = pseudo_gradient(theta_prev, client_thetas)
    updates, opt_state = opt.update(delta, opt_state, theta_prev)
    return apply_updates(theta_prev, updates), opt_state, delta

"""Optimizers as functional transforms over adapter trees (no torch.optim).

Port of ``repro/training/optimizers.py``.  Every optimizer is a pair of
pure functions over trees of tensors, with fp32 state:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``torch.optim`` is not used: the reference puts the decoupled weight decay
inside the Adam step and bias-corrects in fp32, and the port is held to it
step by step.  The step count is a host integer, so no update waits on
the device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lora import tree_map, tree_norm

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# ---------------------------------------------------------------------------
# AdamW: the paper's InnerOpt (PagedAdamW32bit on its GPUs; the paging is a
# memory workaround, plain fp32-state AdamW is the same update).
# ---------------------------------------------------------------------------

def adamw(lr: float = 2e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          schedule: Optional[Callable[[int], float]] = None) -> Optimizer:
    def init(params):
        return {"mu": _zeros_f32(params), "nu": _zeros_f32(params),
                "count": 0}

    def update(grads, state, params=None):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        # bias corrections and the step size in fp32, as the reference
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        step_lr = lr * (schedule(count) if schedule is not None else 1.0)

        def upd(m, v, p):
            mhat = m / c1
            vhat = v / c2
            return -step_lr * (mhat / (torch.sqrt(vhat) + eps)
                               + weight_decay * p.float())

        updates = tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD with (Nesterov) momentum: the paper's OuterOpt.
# ---------------------------------------------------------------------------

def sgd(lr: float = 1e-3, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"v": _zeros_f32(params)}

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g.float(), grads), state
        v = tree_map(lambda vo, g: momentum * vo + g.float(), state["v"],
                     grads)
        if nesterov:
            updates = tree_map(lambda g, vn: -lr * (g.float() + momentum * vn),
                               grads, v)
        else:
            updates = tree_map(lambda vn: -lr * vn, v)
        return updates, {"v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads: Params, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> Params:
    """Scale every leaf by ``min(1, max_norm / ||grads||)`` (global L2 norm
    in fp32); the scale stays on the device.  ``norm``: the norm to clip
    by, where ``grads`` is one rank's shard of the tree (a model group's,
    ``training/train_step.model_group_grads``)."""
    if norm is None:
        norm = tree_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to 1 over ``warmup`` steps, then a cosine to ``floor``
    at ``total``; ``fn(count) -> float``."""
    def fn(count: int) -> float:
        c = float(count)
        if c < warmup:
            return c / max(warmup, 1)
        prog = min(max((c - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog))
    return fn

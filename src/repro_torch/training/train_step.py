"""Train and evaluation steps of LoRA SFT and the AdaFusion objective.

Port of ``repro/training/train_step.py`` for the dense and MoE families:

* ``make_lora_train_step``: the paper's inner step; its loss adds the MoE
  router's aux loss times ``cfg.router_aux_loss_coef`` (0 for a dense
  model), as the reference's does.  The base is frozen:
  gradients come from ``torch.autograd.grad`` over the adapter leaves
  only, then a global-norm clip (1.0) and the optimizer.
* ``make_eval_fn``: next-token cross entropy and accuracy.
* ``make_fused_eval_fn``: the AdaFusion objective (Eq. 8 without its L1
  term): the Eq. 7 merge of a personalized and a global tree, then a
  forward.  On ``"torch"`` it merges with ``core/dual_lora.merge`` and runs
  the plain forward, as the reference does; on ``"cuda"`` every projection
  gets both pairs and the weights, and the dual-LoRA kernel merges on the
  chip, under ``torch.no_grad()``.

``paged_backend`` picks the kernels as everywhere in the port (``None``:
by device; the CPU refuses ``"cuda"``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.dual_lora import dual_tree, merge
from repro_torch.core.lora import lora_scale as _lora_scale
from repro_torch.core.lora import tree_leaves, tree_map
from repro_torch.models.model import resolve_backend
from repro_torch.training.optimizers import (Optimizer, apply_updates,
                                             clip_by_global_norm)

Params = Dict[str, Any]


def cross_entropy(cfg, logits: torch.Tensor,
                  batch) -> Tuple[torch.Tensor, Dict]:
    """Masked next-token cross entropy over ``batch["tokens"]`` (B, S) and
    the optional ``batch["loss_mask"]``; returns (loss, metrics) as device
    scalars."""
    tokens = batch["tokens"]
    lg = logits[:, :-1]
    tg = tokens[:, 1:].long()
    mask = batch.get("loss_mask")
    mask = (mask[:, 1:] if mask is not None
            else torch.ones_like(tg)).float() * (tg >= 0)
    tg = torch.clamp(tg, min=0)
    logp = torch.log_softmax(lg.float(), dim=-1)
    nll = -torch.gather(logp, -1, tg[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((torch.argmax(lg, -1) == tg) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def make_lora_loss_fn(model, cfg,
                      paged_backend: Optional[str] = None) -> Callable:
    scale = _lora_scale(cfg)

    def loss_fn(adapters: Params, params: Params, batch):
        logits, aux = model.forward(params, batch, adapters=adapters,
                                    lora_scale=scale,
                                    paged_backend=paged_backend)
        loss, metrics = cross_entropy(cfg, logits, batch)
        return (loss + cfg.router_aux_loss_coef * aux,
                dict(metrics, aux_loss=aux))

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(trees, *args) -> (loss, metrics, grads)`` for ``loss_fn(trees,
    *args) -> (loss, metrics)``: the gradient of the loss in every leaf of
    ``trees`` (one adapter tree, or a tuple of them, which comes back as a
    list), through ``torch.autograd.grad`` over those leaves only; nothing
    in ``args`` gets a gradient."""
    def fn(trees, *args):
        ts = tree_map(lambda t: t.detach().requires_grad_(True), trees)
        loss, metrics = loss_fn(ts, *args)
        leaves = [t for _, t in tree_leaves(ts)]
        grad_of = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda t: grad_of[id(t)], ts)

    return fn


def lora_value_and_grad(model, cfg,
                        paged_backend: Optional[str] = None) -> Callable:
    """``fn(params, adapters, batch) -> (loss, metrics, grads)`` with the
    gradient of the loss in every adapter leaf (fp32, the tree's layout);
    the base ``params`` get none."""
    vg = value_and_grad(make_lora_loss_fn(model, cfg, paged_backend))

    def fn(params, adapters, batch):
        return vg(adapters, params, batch)

    return fn


def make_lora_train_step(model, cfg, opt: Optimizer, clip_norm: float = 1.0,
                         paged_backend: Optional[str] = None) -> Callable:
    """step(params, adapters, opt_state, batch) -> (adapters, opt_state,
    metrics)."""
    value_and_grad = lora_value_and_grad(model, cfg, paged_backend)

    def step(params, adapters, opt_state, batch):
        _, metrics, grads = value_and_grad(params, adapters, batch)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, opt_state, adapters)
        return apply_updates(adapters, updates), opt_state, metrics

    return step


def make_eval_fn(model, cfg, paged_backend: Optional[str] = None) -> Callable:
    """eval(params, adapters, batch) -> metrics."""
    scale = _lora_scale(cfg)

    @torch.no_grad()
    def evaluate(params, adapters, batch):
        logits, _ = model.forward(params, batch, adapters=adapters,
                                  lora_scale=scale,
                                  paged_backend=paged_backend)
        _, metrics = cross_entropy(cfg, logits, batch)
        return metrics

    return evaluate


def make_fused_eval_fn(model, cfg,
                       paged_backend: Optional[str] = None) -> Callable:
    """eval(params, ad_p, ad_s, w, batch) -> (CE loss, metrics): the
    AdaFusion objective at fusion weights ``w`` = [w1, w2]."""
    scale = _lora_scale(cfg)
    backend = resolve_backend(cfg, paged_backend, model.device).paged_backend

    @torch.no_grad()
    def evaluate(params, ad_p, ad_s, w, batch):
        if backend == "cuda":
            adapters = dual_tree(ad_p, ad_s, w)
        else:
            adapters = merge(ad_p, ad_s, w)
        logits, _ = model.forward(params, batch, adapters=adapters,
                                  lora_scale=scale, paged_backend=backend)
        return cross_entropy(cfg, logits, batch)

    return evaluate

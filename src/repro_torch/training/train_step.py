"""Train and evaluation steps: LoRA SFT, full fine-tuning and the AdaFusion
objective.

Port of ``repro/training/train_step.py`` for every model family (a VLM's
loss skips its patch positions; an encoder-decoder's batch carries
``enc_embeds``):

* ``make_lora_train_step``: the paper's inner step; its loss adds the MoE
  router's aux loss times ``cfg.router_aux_loss_coef`` (0 for a dense
  model), as the reference's does.  The base is frozen:
  gradients come from ``torch.autograd.grad`` over the adapter leaves
  only, then a global-norm clip (1.0) and the optimizer.
* ``make_full_train_step``: full fine-tuning, the paper's cost baseline
  (Table 5) and the step the reference's benchmark harness pretrains its
  base with.  Every leaf of the params tree gets a gradient (a leaf the
  loss never reads gets zeros, as ``jax.grad`` gives it), then the same
  clip and optimizer; bf16 weights are rounded after the update.  No
  adapter is passed, so no projection reaches a LoRA kernel (their
  backwards refuse a gradient for the base weight): on ``"cuda"`` the
  projections are plain ``torch.matmul`` (plain jnp in the reference too)
  and every attention runs the flash-attention kernel.
* ``data_parallel_value_and_grad`` and ``global_token_counts``: the
  LoRA step's gradient over the ``"data"`` group of a mesh, each rank on
  its own rows, keeping the reference's global token mean (below) and,
  for an MoE model, the global batch's expert capacity and aux loss
  (``models/moe.apply_moe`` over the data group).
* ``model_group_grads``: the LoRA step over a mesh's ``"model"`` group
  (``models/tensor_parallel.py``), each rank on its shard of the base
  and adapters: the adapter leaves that every rank holds whole (A of
  the column-parallel targets, B of the row-parallel ones, and the ``B``
  and ``C`` columns of a mamba layer's ``in_proj`` B at one group) get a
  partial gradient on each rank, summed in ONE all-reduce a step, which also
  carries the sharded leaves' squared norms, so the clip reads the
  global norm.
* ``make_eval_fn``: next-token cross entropy and accuracy.
* ``make_fused_eval_fn``: the AdaFusion objective (Eq. 8 without its L1
  term): the Eq. 7 merge of a personalized and a global tree, then a
  forward.  On ``"torch"`` it merges with ``core/dual_lora.merge`` and runs
  the plain forward, as the reference does; on ``"cuda"`` every projection
  gets both pairs and the weights, and the dual-LoRA kernel merges on the
  chip, under ``torch.no_grad()``.

``paged_backend`` picks the kernels as everywhere in the port (``None``:
by device; the CPU refuses ``"cuda"``).

The loss is the reference's ``(nll·mask).sum() / max(mask.sum(), 1)``
over the whole batch, so ranks that split a batch's rows cannot average
their own means (their masks differ).  Over a data group each rank
divides its own sum by the global count (``global_token_counts``: one
all-reduce of the counts, for every batch of a round at once), and one
all-reduce per step sums the gradient trees with the losses and
accuracies folded in; the clip comes after it.  With a model group too,
the data reduce comes first and the model group's after it, so the
squared norms it carries are those of the whole batch's gradient.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.dual_lora import dual_tree, merge
from repro_torch.core.lora import adapter_specs
from repro_torch.core.lora import lora_scale as _lora_scale
from repro_torch.core.lora import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.model import resolve_backend
from repro_torch.training.optimizers import (Optimizer, apply_updates,
                                             clip_by_global_norm)

Params = Dict[str, Any]


def target_mask(batch) -> torch.Tensor:
    """(B, S - 1) fp32: 1 where a next-token target counts in the loss
    (``loss_mask`` if given, and the target id is not negative)."""
    tg = batch["tokens"][:, 1:]
    mask = batch.get("loss_mask")
    return (mask[:, 1:] if mask is not None
            else torch.ones_like(tg)).float() * (tg >= 0)


def _shift_for_family(cfg, logits: torch.Tensor, batch):
    """(logits, targets, mask) aligned for next-token prediction.  A VLM's
    logits start with its ``n_patch_tokens`` patch positions, which no
    target reads: the text's predictions are ``logits[:, Pn:Pn + S - 1]``."""
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        Pn = cfg.n_patch_tokens
        lg = logits[:, Pn:Pn + tokens.shape[1] - 1]
    else:
        lg = logits[:, :-1]
    tg = tokens[:, 1:].long()
    return lg, torch.clamp(tg, min=0), target_mask(batch)


def cross_entropy(cfg, logits: torch.Tensor, batch,
                  denom: Optional[torch.Tensor] = None, tp=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Masked next-token cross entropy over ``batch["tokens"]`` (B, S) and
    the optional ``batch["loss_mask"]``; returns (loss, metrics) as device
    scalars.  ``denom``: divide by it (a data group's global token count)
    instead of this batch's own ``max(mask.sum(), 1)``.  ``tp``: the
    logits are this rank's vocabulary block of a model group
    (``tensor_parallel.vocab_parallel_nll``), or the whole logits where
    the group does not split the vocabulary (``tensor_parallel.
    vocab_split``: the plain loss, no collective); loss and accuracy come
    out the same on every rank of the group."""
    lg, tg, mask = _shift_for_family(cfg, logits, batch)
    if tp is None or not tpl.vocab_split(cfg, tp.size):
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, tg[..., None])[..., 0]
        top = torch.argmax(lg, -1)
    else:
        nll, gmax = tpl.vocab_parallel_nll(lg.float(), tg, tp)
        top = tpl.vocab_parallel_argmax(lg.detach().float(), gmax, tp)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((top == tg) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def make_lora_loss_fn(model, cfg, paged_backend: Optional[str] = None,
                      tp=None, dp=None) -> Callable:
    """``loss_fn(adapters, params, batch, denom=None) -> (loss,
    metrics)``: the cross entropy plus ``router_aux_loss_coef`` times the
    MoE aux loss (``metrics["aux_loss"]``).  With a model group ``tp``
    the trees are this rank's shards and the cross entropy is
    vocabulary-parallel where the group splits the vocabulary.  With a data group ``dp`` the batch is this
    rank's rows and the aux loss the whole batch's, the same on every
    rank: it enters the loss at ``1 / dp.size`` of its value, so the
    ranks' losses are shares of the whole batch's as their cross
    entropies are, with its whole gradient, each rank's rows' own
    (``moe.apply_moe``), so the gradients' sum counts it once."""
    scale = _lora_scale(cfg)

    def loss_fn(adapters: Params, params: Params, batch, denom=None):
        logits, aux = model.forward(params, batch, adapters=adapters,
                                    lora_scale=scale,
                                    paged_backend=paged_backend, tp=tp,
                                    dp=dp)
        loss, metrics = cross_entropy(cfg, logits, batch, denom, tp)
        share = aux if dp is None else tpl.grad_scaled(aux / dp.size,
                                                       dp.size)
        return (loss + cfg.router_aux_loss_coef * share,
                dict(metrics, aux_loss=aux))

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(trees, *args) -> (loss, metrics, grads)`` for ``loss_fn(trees,
    *args) -> (loss, metrics)``: the gradient of the loss in every leaf of
    ``trees`` (an adapter tree, the weights of full fine-tuning, or a
    tuple of trees, which comes back as a list), through
    ``torch.autograd.grad`` over those leaves only; nothing in ``args``
    gets a gradient."""
    def fn(trees, *args):
        ts = tree_map(lambda t: t.detach().requires_grad_(True), trees)
        loss, metrics = loss_fn(ts, *args)
        leaves = [t for _, t in tree_leaves(ts)]
        # a leaf the loss never reads (the encoder-decoder's cross-attention
        # wv adapter) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grad_of = {id(t): torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, grads)}
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


def global_token_counts(batches, reduce: Callable) -> torch.Tensor:
    """The loss denominators of ``batches`` (this rank's rows of each)
    over the ranks that split them: each batch's target tokens summed by
    ``reduce`` (an in-place sum over the data group, as
    ``launch/mesh.all_reduce``) in ONE call, then ``max(count, 1)``;
    (len(batches),) fp32."""
    counts = torch.stack([target_mask(b).sum() for b in batches])
    return torch.clamp(reduce(counts), min=1.0)


def data_parallel_value_and_grad(model, cfg, reduce: Callable, tp=None,
                                 paged_backend: Optional[str] = None,
                                 dp=None) -> Callable:
    """``fn(params, adapters, batches, denoms) -> (metrics, grads)``, one
    entry per (adapter tree, batch, denominator) of this rank (the
    clients it runs, each on its own rows of its batch): the gradient of
    the loss over the whole batch, whose rows the ranks of a data group
    split.  Each rank's loss is its rows' ``(nll·mask).sum()`` over the
    global count (``denoms``, from :func:`global_token_counts`); ONE
    ``reduce`` (an in-place sum over the group) adds every tree's
    gradients with its loss and accuracy folded in, so each rank gets the
    global loss's gradient and metrics (with a model group ``tp``, each
    rank's shard of them: :func:`model_group_grads` follows).  A config
    with experts needs ``dp``, the data group (``launch/mesh.
    data_group``), over which its MoE layers size capacity and take the
    aux loss as the reference does, over the global batch;
    ``metrics["aux_loss"]`` is that, the same on every rank."""
    if cfg.has_moe() and dp is None:
        raise ValueError(f"{cfg.name}: experts over a data axis > 1 need "
                         "its data group (launch.mesh.data_group): expert "
                         "capacity and the router's aux loss span the "
                         "global batch")
    vg = value_and_grad(make_lora_loss_fn(model, cfg, paged_backend, tp, dp))

    def fn(params, adapters, batches, denoms):
        grads, nums, auxes = [], [], []
        for ad, batch, denom in zip(adapters, batches, denoms):
            _, m, g = vg(ad, params, batch, denom)
            grads.append(g)
            nums += [m["loss"], m["accuracy"]]
            auxes.append(m["aux_loss"])
        flat = [tree_flatten(g) for g in grads]
        buf = reduce(torch.cat(flat + [torch.stack(nums).to(flat[0].dtype)]))
        out, off = [], 0
        for g, f in zip(grads, flat):
            out.append(tree_unflatten(buf[off:off + f.numel()], g))
            off += f.numel()
        tail = buf[off:]
        metrics = [{"loss": tail[2 * i], "accuracy": tail[2 * i + 1],
                    "tokens": denoms[i], "aux_loss": auxes[i]}
                   for i in range(len(grads))]
        return metrics, out

    return fn


def model_group_grads(grads, replicated, tp):
    """Gradient trees of a model group's ranks (this rank's shards, one
    tree per client) -> (the trees with every leaf that ``replicated``
    marks (``tensor_parallel.replicated`` of the adapter specs at the
    group's size) summed over the group, each tree's global L2 norm (n,)
    fp32).  The replicated leaves hold a partial gradient on each rank;
    the sharded ones are whole, and their squared norms ride in slots of
    the same buffer, so ONE reduce serves both, and the replicated leaves
    count once.  A leaf marked by a column mask (``in_proj``'s LoRA B,
    whose ``B`` and ``C`` columns every rank holds at ``ssm_n_groups`` 1)
    is both: those columns summed and counted once, the rest its own."""
    def cols(r, t):     # a mask's (whole, own) column indices on t's device
        return tuple(c.nonzero()[:, 0].to(t.device) for c in (r, ~r))

    rep, sq = [], []
    for g in grads:
        own = []

        def sort(r, t):
            if isinstance(r, torch.Tensor):
                whole, mine = cols(r, t)
                rep.append(t.index_select(-1, whole))
                own.append(t.index_select(-1, mine))
            else:
                (rep if r else own).append(t)

        tree_map(sort, replicated, g)
        sq.append(sum(torch.sum(torch.square(t.float())) for t in own))
    buf = tp.reduce(torch.cat([t.reshape(-1).float() for t in rep]
                              + [torch.stack(sq)]), "sum")
    tail = buf[buf.numel() - len(grads):]
    out, norms, off = [], [], 0
    for i, g in enumerate(grads):
        rep_sq = []

        def put(r, t):
            nonlocal off
            if r is False:
                return t
            whole = cols(r, t)[0] if isinstance(r, torch.Tensor) else None
            shape = (t.shape if whole is None
                     else (*t.shape[:-1], whole.numel()))
            v = buf[off:off + math.prod(shape)].view(shape)
            off += v.numel()
            rep_sq.append(torch.sum(torch.square(v)))
            if whole is None:
                return v
            return t.index_copy(-1, whole, v.to(t.dtype))

        out.append(tree_map(put, replicated, g))
        norms.append(torch.sqrt(tail[i] + sum(rep_sq)))
    return out, torch.stack(norms)


def make_lora_train_step(model, cfg, opt: Optimizer, clip_norm: float = 1.0,
                         paged_backend: Optional[str] = None, tp=None,
                         reduce_data: Optional[Callable] = None,
                         dp=None) -> Callable:
    """step(params, adapters, opt_state, batch) -> (adapters, opt_state,
    metrics).  Over a mesh: ``reduce_data`` (an in-place sum over the
    ranks that split the batch's rows; ``dp.reduce`` by default), with
    the data group ``dp`` (which an MoE model needs), takes the gradient
    of the whole batch's loss (:func:`data_parallel_value_and_grad`);
    ``tp`` (a model group) runs each rank on its shards, its replicated
    leaves summed and the clip by the global norm
    (:func:`model_group_grads`)."""
    if tp is not None:
        tpl.check_model_axis(cfg, tp.size)
        replicated = tpl.replicated(adapter_specs(cfg), tp.size)
    if reduce_data is None and dp is not None:
        reduce_data = dp.reduce
    if reduce_data is not None:
        dpvg = data_parallel_value_and_grad(model, cfg, reduce_data, tp,
                                            paged_backend, dp)
    else:
        vg = value_and_grad(make_lora_loss_fn(model, cfg, paged_backend, tp))

    def step(params, adapters, opt_state, batch):
        if reduce_data is not None:
            denom = global_token_counts([batch], reduce_data)
            (metrics,), (grads,) = dpvg(params, [adapters], [batch], denom)
        else:
            _, metrics, grads = vg(adapters, params, batch)
        norm = None
        if tp is not None:
            (grads,), (norm,) = model_group_grads([grads], replicated, tp)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm, norm)
        updates, opt_state = opt.update(grads, opt_state, adapters)
        return apply_updates(adapters, updates), opt_state, metrics

    return step


def full_value_and_grad(model, cfg,
                        paged_backend: Optional[str] = None) -> Callable:
    """``fn(params, batch) -> (loss, metrics, grads)``: the reference's full
    loss (the forward with no adapter; cross entropy plus
    ``cfg.router_aux_loss_coef`` times the MoE aux loss) and its gradient
    in every leaf of ``params``, each in its leaf's dtype."""
    backend = resolve_backend(cfg, paged_backend, model.device).paged_backend

    def loss_fn(params: Params, batch):
        logits, aux = model.forward(params, batch, paged_backend=backend)
        loss, metrics = cross_entropy(cfg, logits, batch)
        return loss + cfg.router_aux_loss_coef * aux, metrics

    return value_and_grad(loss_fn)


def make_full_train_step(model, cfg, opt: Optimizer, clip_norm: float = 1.0,
                         paged_backend: Optional[str] = None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    The gradients are dropped before the new weights are made, so the
    step's peak holds one tree fewer than the arguments, the gradients,
    the new optimizer state, the updates and the new weights together."""
    vg = full_value_and_grad(model, cfg, paged_backend)

    def step(params, opt_state, batch):
        _, metrics, grads = vg(params, batch)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        return apply_updates(params, updates), opt_state, metrics

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

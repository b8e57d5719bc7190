"""Tensor parallelism over a mesh's ``"model"`` axis (Megatron-style).

The reference lets GSPMD split its weights by their partition specs
(``models/layers.py`` and ``core/lora.py`` name ``"model"`` on the head,
ff and vocabulary dims) and inserts the collectives itself.  The port
runs one process per rank, so each rank holds its ``local_shard`` of
those trees and the model says where the sums go:

* column-parallel projections (``wq``, ``wk``, ``wv``, ``w_gate``,
  ``w_up``; the unembedding over the vocabulary): each rank computes its
  block of output columns; the block's input goes through
  :func:`copy_to_group` (identity forward, a sum of the gradients over
  the group backward);
* row-parallel projections (``wo``, ``w_out``): each rank's
  ``x_s·W_s + s·(x_s·A_s)·B`` is its partial of the unsplit product, and
  :func:`reduce_from_group` sums the partials (identity backward);
* the embedding and the cross entropy over a vocabulary split in
  contiguous blocks (:func:`vocab_parallel_embed`,
  :func:`vocab_parallel_nll`, :func:`vocab_parallel_argmax`);
* the experts of an MoE layer (expert parallelism): each rank holds
  ``n_experts / size`` whole experts and runs their copies of the
  dispatch every rank plans alike, its combine a partial of the layer's
  output (``models/moe.apply_moe``).

``wq``'s columns are head-major, so a rank's block is whole heads: the
rank attends its ``n_heads / size`` query heads over its ``n_kv_heads /
size`` kv heads, which is GQA's grouping when both counts divide.  Every
rank runs the same kernels on its shard; there is no new kernel.

Collectives arrive as callables (:class:`ModelGroup`, and
:class:`DataGroup` for the ranks that split a batch's rows, which an MoE
layer's capacity and aux loss span), so nothing here imports
``launch/``: ``launch/mesh.model_group`` and ``data_group`` build the
groups of a mesh, and the dry run's walk logs them on the meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.partition import entry_axes, spec_map

SPLIT_DIMS = ("n_heads", "n_kv_heads", "d_ff", "vocab_size")


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A rank's ``"model"`` group: ``size`` ranks, this one at ``rank``;
    ``reduce(t, op="sum")`` reduces ``t`` in place over the group ("sum",
    "max" or "min") and returns it."""
    size: int
    rank: int
    reduce: Callable


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """A rank's data group, the ranks that split a batch's rows: ``size``
    ranks, this one at ``rank``; ``gather(t)`` concatenates every rank's
    ``t`` along dim 0 in rank order, ``reduce(t, op="sum")`` reduces
    ``t`` in place over the group and returns it.  A rank's rows follow
    the lower ranks' rows, so a gather restores the batch's flat order."""
    size: int
    rank: int
    gather: Callable
    reduce: Callable


def local_config(cfg, size: int):
    """``cfg`` at one rank's shard of a ``size``-way model axis: heads, kv
    heads, ff columns and vocabulary divided by ``size`` (the head dim and
    the experts' width pinned); ``n_experts`` stays global, since every
    rank's router ranks all the experts, and must divide too.  Refused,
    naming the dim, where one does not divide."""
    moe = {"d_ff_moe": cfg.resolved_d_ff_moe} if cfg.has_moe() else {}
    for name in SPLIT_DIMS + tuple(("n_experts",) if moe else ()):
        n = getattr(cfg, name)
        if n % size:
            raise ValueError(f"{cfg.name}: {name} {n} does not divide over "
                             f"a \"model\" axis of {size}")
    return cfg.with_overrides(head_dim=cfg.resolved_head_dim, **moe,
                              **{n: getattr(cfg, n) // size
                                 for n in SPLIT_DIMS})


def check_model_axis(cfg, size: int):
    """The local config of ``cfg`` at a ``size``-way model axis, or a
    ``ValueError`` naming what is not ported: the dense and MoE families
    are split (attention, the dense MLP, the experts), with every split
    count dividing."""
    if size == 1:
        return cfg
    family = {"ssm": "mamba layers (the reference splits SSM heads on it, "
                     "src/repro/models/mamba2.py)",
              "vlm": "the VLM's patch embeddings",
              "encdec": "the encoder-decoder"}
    kind = "ssm" if cfg.has_mixer("mamba") else cfg.family
    if kind in family:
        raise ValueError(f"{cfg.name}: not ported over a \"model\" axis > 1:"
                         f" {family[kind]}; it runs the dense and MoE "
                         "families only")
    return local_config(cfg, size)


def shard_leaf(t: torch.Tensor, spec, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along the dim its spec splits over
    ``"model"`` (a copy, so the whole leaf can go), or ``t`` itself."""
    for d, e in enumerate(spec):
        if "model" in entry_axes(e):
            w = t.shape[d] // size
            return t.narrow(d, rank * w, w).clone()
    return t


def grad_scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` forward (bit for bit); its gradient times ``s`` backward."""
    d = t.detach()
    return d + (t - d) * s


def replicated(spec_tree):
    """Per leaf of a spec tree: True where no dim names ``"model"`` (the
    leaf is whole on every rank of the group)."""
    return spec_map(lambda s: not any("model" in entry_axes(e) for e in s),
                    spec_tree)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce(g.clone(memory_format=torch.contiguous_format),
                             "sum"), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.reduce(x.clone(memory_format=torch.contiguous_format),
                         "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The input of a column-parallel block: ``x`` forward; its gradient,
    a partial on each rank, summed over the group backward."""
    return _CopyToGroup.apply(x, tp)


def reduce_from_group(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The output of a row-parallel block: each rank's partial summed over
    the group (in ``x``'s dtype); the gradient passes whole."""
    return _ReduceFromGroup.apply(x, tp)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         tp: ModelGroup) -> torch.Tensor:
    """Rows of the embedding whose vocabulary is split in contiguous
    blocks (``embed``: this rank's (V / size, d)): a token outside the
    rank's block reads zeros, then one sum over the group, exact since one
    rank holds each row."""
    V = embed.shape[0]
    local = tokens.long() - tp.rank * V
    inside = (local >= 0) & (local < V)
    rows = embed[local.clamp(0, V - 1)].masked_fill(~inside[..., None], 0)
    return reduce_from_group(rows, tp)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, tp):
        V = logits.shape[-1]
        gmax = tp.reduce(logits.amax(-1).contiguous(), "max")
        e = torch.exp(logits - gmax[..., None])
        local = targets.long() - tp.rank * V
        inside = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1)
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0] - gmax
        # the sum of exps and the target's shifted logit in one reduce
        buf = tp.reduce(torch.stack([e.sum(-1),
                                     tgt.masked_fill(~inside, 0.0)]), "sum")
        nll = torch.log(buf[0]) - buf[1]
        ctx.save_for_backward(e, buf[0], idx, inside)
        ctx.mark_non_differentiable(gmax)
        return nll, gmax

    @staticmethod
    def backward(ctx, g, _):
        e, sumexp, idx, inside = ctx.saved_tensors
        grad = e / sumexp[..., None]                 # the softmax's block
        grad.scatter_add_(-1, idx[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       tp: ModelGroup):
    """(nll, max): the negative log-likelihood of ``targets`` (global ids)
    under fp32 ``logits`` (..., V / size) whose vocabulary is split over
    the group, and the global max logit per position.  Forward: a max and
    one sum of (2, ...) over the group; backward: this rank's softmax
    block less the target's one-hot, no collective."""
    return _VocabParallelNLL.apply(logits, targets, tp)


def vocab_parallel_argmax(logits: torch.Tensor, gmax: torch.Tensor,
                          tp: ModelGroup) -> torch.Tensor:
    """The global argmax of logits split over the group, ``gmax`` the
    global max: among the ranks whose block holds ``gmax``, the lowest
    global index (one "min" reduce), so ties go to the first index, as
    ``torch.argmax`` breaks them over the whole vocabulary."""
    V = logits.shape[-1]
    idx = torch.argmax(logits, -1)
    top = torch.gather(logits, -1, idx[..., None])[..., 0]
    cand = torch.where(top == gmax, idx + tp.rank * V,
                       torch.full_like(idx, tp.size * V))
    return tp.reduce(cand, "min")


def vocab_parallel_greedy(logits: torch.Tensor,
                          tp: ModelGroup) -> torch.Tensor:
    """The global argmax of fp32 logits (..., V / size) split over the
    group, in one "sum" reduce: each rank writes its block's top logit and
    that logit's global index into its row of a zeroed (size, ..., 2)
    buffer (an all-gather, exact since the other ranks add zeros; an
    index below 2^24 is exact in fp32), then every rank picks the first
    row holding the largest top, so ties go to the lowest global index,
    as ``torch.argmax`` breaks them over the whole vocabulary.  Returns
    int64 indices of ``logits.shape[:-1]``."""
    V = logits.shape[-1]
    idx = torch.argmax(logits, -1)
    top = torch.gather(logits, -1, idx[..., None])[..., 0]
    buf = torch.zeros((tp.size, *top.shape, 2), dtype=torch.float32,
                      device=logits.device)
    if not logits.is_meta:
        buf[tp.rank, ..., 0] = top
        buf[tp.rank, ..., 1] = (idx + tp.rank * V).float()
    buf = tp.reduce(buf, "sum")
    best = torch.argmax(buf[..., 0], 0)
    return torch.gather(buf[..., 1], 0, best[None])[0].long()

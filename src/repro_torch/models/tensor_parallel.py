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
  :func:`vocab_parallel_nll`, :func:`vocab_parallel_argmax`), where the
  axis divides it (:func:`vocab_split`); a vocabulary it does not divide
  stays whole on every rank, as the reference's dry run drops such an
  axis (``_shardings``), and no collective touches it: a plain lookup,
  whole logits, the plain cross entropy;
* the experts of an MoE layer (expert parallelism): each rank holds
  ``n_experts / size`` whole experts and runs their copies of the
  dispatch every rank plans alike, its combine a partial of the layer's
  output (``models/moe.apply_moe``);
* a mamba layer's SSM heads (``models/mamba2.apply_mamba``): ``in_proj``
  and the depthwise conv are column-parallel, but their columns are
  segments (``[z | x | B | C | dt]``, the conv's ``[x | B | C]``), so a
  rank's block is its heads' columns of each segment, and ``B``/``C``
  whole where ``ssm_n_groups`` is 1 (:class:`Segments`,
  :func:`segment_cut`); the gated norm's mean of squares over the whole
  ``d_inner`` is one sum over the group (:func:`sum_over_group`) and
  ``out_proj`` is row-parallel.

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

HEAD_DIMS = ("n_heads", "n_kv_heads", "d_ff")


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


def vocab_split(cfg, size: int) -> bool:
    """Whether a ``size``-way model axis splits the vocabulary of ``cfg``
    (a config, or a :class:`Vocab` spec entry): where ``vocab_size``
    divides.  Where it does not, ``embed`` and ``lm_head`` stay whole on
    every rank, as the reference's dry run lays them out (its
    ``_shardings`` drops an axis that does not divide a dim), and no
    collective touches the vocabulary: the lookup is plain, the logits
    whole on every rank, the loss the plain cross entropy and a greedy
    or sampled token read the whole logits.  The one rule every caller
    reads."""
    return cfg.vocab_size % size == 0


class Vocab(str):
    """A spec entry naming the ``"model"`` axis (it equals the name, as
    the reference's spec names it) over a vocabulary of ``vocab_size``
    entries: :func:`shard_leaf`, :func:`join_leaf` and
    ``federated/distributed.local_shard`` split such a dim in contiguous
    blocks where :func:`vocab_split` says the axis divides it, and keep
    it whole on every rank where it does not."""

    def __new__(cls, axis: str, vocab_size: int):
        out = super().__new__(cls, axis)
        out.vocab_size = int(vocab_size)
        return out

    def __reduce__(self):
        return (Vocab, (str(self), self.vocab_size))

    def __repr__(self) -> str:
        return f"Vocab({str(self)!r}, {self.vocab_size})"


def whole_at(entry, size: int) -> bool:
    """True where a spec entry's dim stays whole at a ``size``-way model
    axis though the entry names it: a :class:`Vocab` the axis does not
    divide."""
    return isinstance(entry, Vocab) and not vocab_split(entry, size)


def _split_dims(cfg):
    """The counts a model axis divides: attention's heads and kv heads
    and ``d_ff`` where the config has an attention layer or a dense MLP
    (mamba2 has neither; its ``n_heads`` and ``d_ff`` are placeholders);
    then the checked-only counts: the experts (every rank's router ranks
    all of them) and the SSM heads (a mamba layer sizes its share from
    the global config and the group).  The vocabulary is split where it
    divides and whole otherwise (:func:`vocab_split`)."""
    split = (HEAD_DIMS if any(e.startswith("attn") or e.endswith("+mlp")
                              for e in cfg.layer_pattern) else ())
    checked = (("n_experts",) if cfg.has_moe() else ()) + (
        ("ssm_n_heads",) if cfg.has_mixer("mamba") else ())
    return split, checked


def local_config(cfg, size: int):
    """``cfg`` at one rank's shard of a ``size``-way model axis: heads, kv
    heads and ff columns divided by ``size`` where the config has what
    reads them (the head dim and the experts' width pinned), the
    vocabulary where :func:`vocab_split` says so (else whole);
    ``n_experts`` and a mamba layer's counts stay global (every rank's
    router ranks all the experts; ``ssm_d_inner`` is ``ssm_expand ·
    d_model``, so ``apply_mamba`` sizes its share from ``tp.size``) and
    must divide too (``ssm_n_groups`` may be 1 instead: whole on every
    rank).  Refused, naming the count, where one does not divide."""
    moe = {"d_ff_moe": cfg.resolved_d_ff_moe} if cfg.has_moe() else {}
    split, checked = _split_dims(cfg)
    for name in split + checked:
        n = getattr(cfg, name)
        if n % size:
            raise ValueError(f"{cfg.name}: {name} {n} does not divide over "
                             f"a \"model\" axis of {size}")
    g = cfg.ssm_n_groups
    if cfg.has_mixer("mamba") and g % size and g != 1:
        raise ValueError(f"{cfg.name}: ssm_n_groups {g} neither divides "
                         f"over a \"model\" axis of {size} nor is 1 (whole "
                         "on every rank)")
    if vocab_split(cfg, size):
        split += ("vocab_size",)
    return cfg.with_overrides(head_dim=cfg.resolved_head_dim, **moe,
                              **{n: getattr(cfg, n) // size for n in split})


def check_model_axis(cfg, size: int):
    """The local config of ``cfg`` at a ``size``-way model axis, or a
    ``ValueError`` naming the count that does not divide: every family
    is split (attention, the dense and GELU MLPs, the experts, the SSM
    heads; the VLM's patch embeddings whole on every rank, the
    encoder-decoder's encoder, decoder and cross-attention alike)."""
    if size == 1:
        return cfg
    return local_config(cfg, size)


class Segments(str):
    """A spec entry naming the ``"model"`` axis (it equals the name, as
    the reference's spec names it) over a dim laid out in segments:
    ``segments`` ((width, units), ...) in order, each ``units`` heads or
    groups wide.  A ``size``-way axis gives each rank its block of every
    segment whose units divide (whole heads or groups) and the whole of
    a segment of one unit: the port's head-aligned cut of a mamba
    layer's ``in_proj`` and conv columns, where the reference's GSPMD
    layout would cut the concatenation contiguously.  :func:`shard_leaf`,
    :func:`join_leaf`, ``federated/distributed.local_shard`` and
    ``serving/registry.model_shard`` cut such a dim with
    :func:`segment_cut`."""

    def __new__(cls, axis: str, segments):
        out = super().__new__(cls, axis)
        out.segments = tuple((int(w), int(u)) for w, u in segments)
        return out

    def __reduce__(self):
        return (Segments, (str(self), self.segments))

    def __repr__(self) -> str:
        return f"Segments({str(self)!r}, {self.segments!r})"


def _layout(segments, size: int):
    """Per segment at a ``size``-way axis: (global start, local start,
    width on a rank, split).  Refused where a segment's units neither
    divide nor are 1."""
    out, g, l = [], 0, 0
    for width, units in segments:
        if units % size == 0:
            w, split = width // size, True
        elif units == 1:
            w, split = width, False
        else:
            raise ValueError(f"a segment of {units} units does not divide "
                             f"over a \"model\" axis of {size}")
        out.append((g, l, w, split))
        g, l = g + width, l + w
    return out


def segment_cut(t: torch.Tensor, dim: int, segments, size: int,
                rank: int) -> torch.Tensor:
    """Rank ``rank``'s columns of ``t`` along ``dim``, laid out in
    ``segments``: per segment its block of whole heads or groups, or the
    whole segment where it is one unit, in order (a new tensor)."""
    return torch.cat([t.narrow(dim, g + (rank * w if split else 0), w)
                      for g, _, w, split in _layout(segments, size)], dim)


def segment_join(parts, dim: int, segments) -> torch.Tensor:
    """The inverse of :func:`segment_cut`: the whole dim from every
    rank's cut (``parts`` in rank order), a segment whole on every rank
    taken from rank 0's."""
    out = []
    for _, l, w, split in _layout(segments, len(parts)):
        out += [p.narrow(dim, l, w) for p in (parts if split
                                               else parts[:1])]
    return torch.cat(out, dim)


def replicated_columns(segments, size: int) -> torch.Tensor:
    """(local width,) bool: True at a rank's columns of a segmented dim
    that every rank holds whole (``B`` and ``C`` of ``in_proj`` at
    ``ssm_n_groups`` 1)."""
    lay = _layout(segments, size)
    mask = torch.zeros(lay[-1][1] + lay[-1][2], dtype=torch.bool)
    for _, l, w, split in lay:
        if not split:
            mask[l:l + w] = True
    return mask


def shard_leaf(t: torch.Tensor, spec, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along the dim its spec splits over
    ``"model"`` (a copy, so the whole leaf can go; a :class:`Segments`
    dim by :func:`segment_cut`), or ``t`` itself (a :class:`Vocab` dim
    the axis does not divide, too)."""
    for d, e in enumerate(spec):
        if "model" in entry_axes(e):
            if isinstance(e, Segments):
                return segment_cut(t, d, e.segments, size, rank)
            if whole_at(e, size):
                return t
            w = t.shape[d] // size
            return t.narrow(d, rank * w, w).clone()
    return t


def join_leaf(spec, leaves):
    """The inverse of :func:`shard_leaf` over every rank's shard
    (``leaves`` in model-coordinate order): concatenated along the dim
    the spec splits over ``"model"`` (a :class:`Segments` dim by
    :func:`segment_join`), or rank 0's where the spec splits none (or a
    :class:`Vocab` dim the axis does not divide)."""
    for d, e in enumerate(spec):
        if "model" in entry_axes(e):
            if isinstance(e, Segments):
                return segment_join(leaves, d, e.segments)
            if whole_at(e, len(leaves)):
                return leaves[0]
            return torch.cat(leaves, d)
    return leaves[0]


def grad_scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` forward (bit for bit); its gradient times ``s`` backward."""
    d = t.detach()
    return d + (t - d) * s


def replicated(spec_tree, size: int = 1):
    """Per leaf of a spec tree: True where no dim names ``"model"`` (the
    leaf is whole on every rank of the group), else False.  Given the
    axis' ``size``, a leaf whose last dim is :class:`Segments` with
    segments whole on every rank at that size (``in_proj``'s LoRA B at
    ``ssm_n_groups`` 1) gets the (local width,) bool mask of those
    columns instead (:func:`replicated_columns`)."""
    def one(spec):
        if not any("model" in entry_axes(e) for e in spec):
            return True
        last = spec[len(spec) - 1]
        if size > 1 and isinstance(last, Segments):
            mask = replicated_columns(last.segments, size)
            if bool(mask.any()):
                return mask
        return False
    return spec_map(one, spec_tree)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce(g.clone(memory_format=torch.contiguous_format),
                             "sum"), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.reduce(x.clone(memory_format=torch.contiguous_format),
                         "sum")

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


def sum_over_group(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """Each rank's partial summed over the group, where every rank then
    uses the sum in its own way (a mamba layer's gated norm scales its
    own columns by it): the gradient, a partial on each rank, is summed
    over the group too."""
    return _SumOverGroup.apply(x, tp)


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

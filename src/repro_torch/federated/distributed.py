"""One FDLoRA round over client-stacked state, on one rank or on a mesh.

Port of ``repro/federated/distributed.py``: one federated round (K inner
AdamW steps per client, then the server's outer step) as one function over
state stacked on a leading client axis:

    adapters / inner optimizer state:  (N_clients, ...)  P("pod", ...)
    batches:                           (N_clients, K, B, S)
                                       P("pod", None, "data", None)
    base model:                        replicated

The reference maps the clients with ``jax.vmap`` and lets the mesh place
them, one client per pod; the pseudo-gradient mean over the client axis
is its only cross-pod all-reduce, of LoRA-sized tensors.

One round serves both.  ``mesh=None`` is one pod: every client on this
rank, one after another in a Python loop over the client axis (the
kernels launch through ctypes, which ``torch.func.vmap`` cannot map),
and no collective.  With a mesh (``launch/mesh.py``) each rank takes its
shard of the stacked state and batches (:func:`local_shard`): the
clients of its ``"pod"`` coordinate, on the rows of its ``"data"``
coordinate.  Inside the round the data group reduces gradients
(``training/train_step.data_parallel_value_and_grad``: one all-reduce of
the token counts, then one per inner step; none at data 1).  Then the
round issues ONE all-reduce on the ``"pod"`` group, the round's only
cross-client traffic: each rank's share of the clients' mean (its
clients' adapter trees, or their bf16 pseudo-gradients under
``compress_outer="bf16"``, summed in fp32, over the client count, cast
for the wire), flattened into one buffer with each client's loss in a
slot of its own.  Every rank applies the same outer step to the same
mean, so θ_s' is identical on all ranks.  At one client a rank the
shares are exact halves at pod 2, so their sum, rounded once, is the
meshless round's mean bit for bit.

With a ``"model"`` axis > 1 (every family; ``models/
tensor_parallel.py``) each rank holds its shard of the base, of θ_s and
of the state (heads, ff columns, experts and SSM heads split over the
model group, the vocabulary where the axis divides it and whole on every
rank where it does not, a mamba layer's ``in_proj`` columns by heads
within each segment, ``local_shard`` under ``param_specs`` and
:func:`state_specs`; a VLM's patch embeddings and an encoder-decoder's
frames are batch inputs, their rows over "data" as the tokens'):
the forward and backward sum activations over the group, and each step
ONE model all-reduce (after the data one) sums the adapter leaves every
rank holds whole and carries the clip's squared norms
(``training/train_step.model_group_grads``).  The pod all-reduce stays
one a round: each model coordinate has its own pod group and reduces its
own shard.  An MoE layer at ``"data"`` > 1 sizes its experts' capacity
and takes its aux loss over the client's whole batch, as the reference's
does (one gather of the routing ids over the data group a layer, and
one (2, E) sum; ``models/moe.apply_moe``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.lora import (adapter_specs, tree_flatten, tree_map,
                                   tree_unflatten)
from repro_torch.core.partition import (P, entry_axes, mesh_coordinate,
                                        mesh_shape, spec_map)
from repro_torch.launch.mesh import all_reduce, data_group, model_group
from repro_torch.launch.specs import sharding_tree
from repro_torch.models import tensor_parallel as tpl
from repro_torch.training.optimizers import (Optimizer, apply_updates,
                                             clip_by_global_norm)
from repro_torch.training.train_step import (data_parallel_value_and_grad,
                                             global_token_counts,
                                             make_lora_loss_fn,
                                             model_group_grads,
                                             value_and_grad)

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


def client_stacked_specs(adapter_spec_tree, n_clients_axis: str = "pod"):
    """Prepend the client axis (on ``"pod"``) to adapter specs."""
    return spec_map(lambda s: P(n_clients_axis, *s), adapter_spec_tree)


def batch_specs(kind: str = "train") -> P:
    """(N_clients, K, B, S): clients on "pod", batch rows on "data"."""
    return P("pod", None, "data", None)


def state_specs(adapter_spec_tree, state: Dict) -> Dict:
    """Specs of a round's stacked state: the inner optimizer's trees and
    the personalized adapters along "pod" (AdamW's step count, a numpy
    (N,), too); the outer optimizer's state replicated over "pod" and
    "data", its trees split over "model" as the adapters are."""
    stacked = client_stacked_specs(adapter_spec_tree)
    on_model = spec_map(lambda s: P() if tpl.replicated(s) else s,
                        adapter_spec_tree)
    out = {}
    for key, sub in state.items():
        if key == "inner_opt":
            out[key] = {k: stacked if isinstance(v, dict) else P("pod")
                        for k, v in sub.items()}
        elif key == "personalized":
            out[key] = stacked
        else:
            out[key] = {k: on_model if isinstance(v, dict)
                        else tree_map(lambda _: P(), v)
                        for k, v in sub.items()}
    return out


def local_shard(tree, spec_tree, mesh):
    """This rank's shard of ``tree`` (tensors, numpy arrays; other leaves
    pass whole) under ``spec_tree``: along every dim whose spec names
    mesh axes of size > 1, the block of this rank's coordinate in them
    (the first axis major), contiguous (a view where the block already
    is; a ``tensor_parallel.Segments`` dim by heads within each
    segment, ``tensor_parallel.segment_cut``; a ``tensor_parallel.Vocab``
    dim the axis does not divide stays whole, as the reference lays the
    vocabulary out).  Axes the mesh lacks are dropped (``launch/specs.
    sharding_tree``); unlike ``sharding_tree`` any other axis that does
    not divide its dim is refused, since a rank's rows must be its
    own."""
    sizes, coord = mesh_shape(mesh), mesh_coordinate(mesh)

    def take(spec, leaf):
        if not hasattr(leaf, "shape"):
            return leaf
        for d, e in enumerate(sharding_tree(mesh, spec)):
            n, c = 1, 0
            for a in entry_axes(e):
                n, c = n * sizes[a], c * sizes[a] + coord[a]
            if n == 1:
                continue
            if isinstance(e, tpl.Segments):
                leaf = tpl.segment_cut(leaf, d, e.segments, n, c)
                continue
            if tpl.whole_at(e, n):
                continue
            if leaf.shape[d] % n:
                raise ValueError(f"local_shard: dim {d} of {tuple(leaf.shape)}"
                                 f" does not divide over {e!r} ({n} ranks)")
            w = leaf.shape[d] // n
            leaf = leaf[(slice(None),) * d + (slice(c * w, (c + 1) * w),)]
        if isinstance(leaf, torch.Tensor):
            return leaf.contiguous()
        return np.ascontiguousarray(leaf)

    return spec_map(take, spec_tree, tree)


def make_fdlora_round_step(model, cfg, inner_opt: Optimizer,
                           outer_opt: Optimizer, inner_steps: int,
                           sync_personalized: bool = False,
                           compress_outer: str = "none",
                           mesh=None) -> Callable:
    """Returns round(base, theta_s, stacked_state, batches) -> (theta_s',
    state', loss).

    stacked_state = {"inner_opt": (N, ...), "outer_opt": {...}, and
    "personalized" (N, ...) when ``sync_personalized``}; batches: dict of
    (N, K, B, S) tensors.  The pseudo-gradient θ_s − mean_i θ_i is shipped
    in fp32, or in bf16 under ``compress_outer="bf16"`` (each client's
    θ_s − θ_i rounded to bf16, their mean taken in fp32 and rounded to
    bf16 once, as the reference's; the outer step itself stays fp32).
    ``loss`` is the mean over clients of each client's mean over its K
    steps (a device scalar).  The kernels follow the model's device and
    config (``"cuda"`` on a card).

    With ``mesh`` (``launch/mesh.make_mesh``) the state and batches are
    this rank's shards (:func:`local_shard` under :func:`state_specs` and
    :func:`batch_specs`), θ_s and the outer state are replicated over
    "pod" and "data", and the round returns θ_s' and the loss (the same
    on every rank of a model coordinate) and this rank's shard of the new
    state.  At ``"model"`` > 1 the base, θ_s and the outer state are this
    rank's shards too (``local_shard`` under the model's ``param_specs``
    and ``core/lora.adapter_specs``), for every family, a vocabulary the
    axis does not divide whole on every rank; refused there, naming the
    count, where a head, kv-head, ff, expert or SSM-head count does not
    divide (or SSM groups neither divide nor are 1).
    ``mesh=None`` is one pod holding every client, with no collective.
    """
    if compress_outer not in ("none", "bf16"):
        raise ValueError(f"unknown compress_outer {compress_outer!r}")
    sizes = {"pod": 1} if mesh is None else mesh_shape(mesh)
    if "pod" not in sizes:
        raise ValueError(f"mesh {sizes}: the round's clients ride a \"pod\" "
                         "axis; make the mesh with launch.mesh.make_mesh")
    tpl.check_model_axis(cfg, sizes.get("model", 1))
    tp = None if mesh is None else model_group(mesh)
    if tp is not None:
        replicated = tpl.replicated(adapter_specs(cfg), tp.size)
    data_parallel = sizes.get("data", 1) > 1
    if data_parallel:
        dp = data_group(mesh)
        reduce_data = dp.reduce
        dp_grads = data_parallel_value_and_grad(model, cfg, reduce_data, tp,
                                                dp=dp)
    else:
        vg = value_and_grad(make_lora_loss_fn(model, cfg, tp=tp))
    pods = sizes["pod"]
    wire = torch.bfloat16 if compress_outer == "bf16" else torch.float32

    def round_step(base, theta_s, state: Dict, batches: Dict):
        n_local = next(iter(batches.values())).shape[0]
        client = [{n: v[i] for n, v in batches.items()}
                  for i in range(n_local)]
        ads = [theta_s] * n_local
        sts = [client_slice(state["inner_opt"], i) for i in range(n_local)]
        losses: List[List[torch.Tensor]] = [[] for _ in range(n_local)]
        if data_parallel:   # every count of the round in one all-reduce
            denoms = global_token_counts(
                [{n: v[k] for n, v in c.items()} for c in client
                 for k in range(inner_steps)], reduce_data
            ).view(n_local, inner_steps)
        # -- inner phase: K AdamW steps a client, clients independent;
        # step-major, so a data group reduces once a step
        for k in range(inner_steps):
            step = [{n: v[k] for n, v in c.items()} for c in client]
            if data_parallel:
                metrics, grads = dp_grads(base, ads, step, denoms[:, k])
            else:
                metrics, grads = [], []
                for ad, b in zip(ads, step):
                    _, m, g = vg(ad, base, b)
                    metrics.append(m)
                    grads.append(g)
            norms = [None] * n_local
            if tp is not None:
                grads, norms = model_group_grads(grads, replicated, tp)
            for i in range(n_local):
                g = clip_by_global_norm(grads[i], 1.0, norms[i])
                upd, sts[i] = inner_opt.update(g, sts[i], ads[i])
                ads[i] = apply_updates(ads[i], upd)
                losses[i].append(metrics[i]["loss"])
        client_loss = [torch.stack(l).mean() for l in losses]
        # -- outer phase: the clients' mean, this rank's share summed in
        # fp32 and cast for the wire; with a mesh ONE all-reduce over the
        # pod group adds the shares, each client's loss in a slot of its own
        n_clients = n_local * pods
        if compress_outer == "bf16":
            parts = [tree_map(lambda prev, ti: (prev - ti).to(wire),
                              theta_s, ad) for ad in ads]
        else:
            parts = ads
        share = tree_map(lambda *p: (torch.stack(p).sum(
            0, dtype=torch.float32) / n_clients).to(wire), *parts)
        flat = tree_flatten(share)
        first = 0 if mesh is None else mesh_coordinate(mesh)["pod"] * n_local
        buf = torch.cat([flat, _loss_slots(client_loss, first, n_clients,
                                           wire)])
        if mesh is not None:
            all_reduce(buf, mesh, "pod")
        mean = tree_unflatten(buf[:flat.numel()], theta_s)
        if compress_outer == "bf16":
            delta = tree_map(lambda m: m.float(), mean)
        else:
            delta = tree_map(lambda prev, m: prev - m, theta_s, mean)
        loss = _read_slots(buf[flat.numel():], n_clients).mean()
        upd, outer_state = outer_opt.update(delta, state["outer_opt"],
                                            theta_s)
        theta_s_new = apply_updates(theta_s, upd)
        new_state = dict(state, inner_opt=stack_clients(sts),
                         outer_opt=outer_state)
        if sync_personalized:  # Algorithm 1 lines 13-15 (H-round sync)
            new_state["personalized"] = stack_clients(ads)
        return theta_s_new, new_state, loss

    return round_step


def _loss_slots(client_loss, first: int, n: int, dtype) -> torch.Tensor:
    """The clients' losses in slots of their own (client ``first + i`` at
    slot ``first + i``, zeros elsewhere), so the sum over the pod group
    carries each exactly.  In a bf16 buffer each fp32 loss rides as its
    four bytes, each an integer 0-255 that bf16 holds exactly."""
    dev = client_loss[0].device
    if dtype == torch.bfloat16:
        out = torch.zeros((n, 4), dtype=dtype, device=dev)
        for i, l in enumerate(client_loss):
            out[first + i] = l.float().reshape(1).view(torch.uint8).to(dtype)
        return out.reshape(-1)
    out = torch.zeros(n, dtype=dtype, device=dev)
    for i, l in enumerate(client_loss):
        out[first + i] = l
    return out


def _read_slots(slots: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) fp32 losses from :func:`_loss_slots`' buffer after the sum."""
    if slots.dtype == torch.bfloat16:
        return slots.view(n, 4).to(torch.uint8).view(torch.float32)[:, 0]
    return slots

"""Decoder: init, forward and the paged serving steps.

Port of the dense, MoE, SSM, hybrid and VLM families of
``repro/models/model.py`` (the encoder-decoder is ``models/encdec.py``).  Parameters are a plain dict: ``embed`` (V,
d), ``final_norm``, ``layers`` (one dict per layer: ``norm1``, ``mixer``:
attention {wq, wk, wv, wo} or a mamba block (``models/mamba2.py``), and,
unless the layer's MLP is ``"none"``, ``norm2`` and ``mlp``: the dense
MLP, or the fp32 router and the expert stacks (E, d_in, d_out) of an MoE
layer) and, untied, ``lm_head`` (d, V).  The reference stacks layers on
a period axis for ``lax.scan``; here a Python loop walks the list.
Adapter trees and banks follow the same per-layer layout
(``core/lora.py``), as do decode caches: an attention layer's K/V (a ring
buffer, or a block pool shared by the serving slots) or a mamba layer's
per-row recurrent state.

``param_specs``, ``decode_cache_specs`` and ``paged_decode_cache_specs``
give the partition specs (``core/partition.P``) of those trees, layer by
layer: the reference's spec of a stacked leaf without its period entry.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.configs.base import PAGED_BACKENDS, torch_dtype
from repro_torch.core.partition import spec_map
from repro_torch.kernels.lora_matmul import lora_matmul_op
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_lib
from repro_torch.models import tensor_parallel as tpl

Params = Dict[str, Any]


def init_params(cfg, seed: int = 0, device="cuda",
                shard: Optional[Tuple[int, int]] = None) -> Params:
    """Random weights from ``seed``: the reference's init scales (normal ×
    d^-0.5 for projections and the fp32 router, × d_ff^-0.5 for w_out,
    × 0.02 for embeddings; a mamba layer's as ``mamba2.init_mamba`` says),
    drawn by a ``torch.Generator`` on ``device`` (the card unless the
    caller asks for the CPU).  On the meta device the tree has the same
    shapes and dtypes and no values (``launch/dryrun.py``).

    ``shard`` (size, rank): rank ``rank``'s shard of a ``size``-way model
    axis under :func:`param_specs`, the same values as the whole tree's
    block, with no whole copy held: each leaf is cut as it is drawn, an
    expert stack an expert at a time."""
    if shard is not None:
        tpl.check_model_axis(cfg, shard[0])
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    normal = normal_init(seed, dev, dtype)

    def norm():
        if cfg.norm_type == "nonparametric":
            return {}
        p = {"scale": torch.ones(d, device=dev)}
        if cfg.norm_type == "layernorm":
            p["bias"] = torch.zeros(d, device=dev)
        return p

    def cut(tree, specs):
        if shard is None:
            return tree
        return spec_map(lambda s, t: tpl.shard_leaf(t, s, *shard), specs,
                        tree)

    experts = None
    if shard is not None and cfg.has_moe():
        n = cfg.n_experts // shard[0]
        experts = range(shard[1] * n, (shard[1] + 1) * n)
    layers = []
    for i in range(cfg.n_layers):
        mixer, mlp_kind = _parse(cfg.layer_entry(i))
        specs = _layer_specs(cfg, i)
        layer = {"norm1": norm()}
        if mixer == "attn":
            layer["mixer"] = {"wq": normal((d, H * hd), d ** -0.5),
                              "wk": normal((d, Kv * hd), d ** -0.5),
                              "wv": normal((d, Kv * hd), d ** -0.5),
                              "wo": normal((H * hd, d), d ** -0.5)}
        else:
            layer["mixer"] = mamba2.init_mamba(normal, cfg, dev)
        layer["mixer"] = cut(layer["mixer"], specs["mixer"])
        if mlp_kind == "moe":
            mlp = moe_lib.init_moe(normal, d, cfg.resolved_d_ff_moe,
                                   cfg.n_experts, cfg.mlp_type, experts)
        elif mlp_kind == "mlp":
            mlp = {"w_up": normal((d, ff), d ** -0.5),
                   "w_out": normal((ff, d), ff ** -0.5)}
            if cfg.mlp_type in ("swiglu", "geglu"):
                mlp["w_gate"] = normal((d, ff), d ** -0.5)
            mlp = cut(mlp, specs["mlp"])
        if mlp_kind != "none":
            layer["norm2"], layer["mlp"] = norm(), mlp
        layers.append(layer)
    params = {"embed": cut(normal((V, d), 0.02), L.embed_specs(V)),
              "final_norm": norm(), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = cut(normal((d, V), 0.02), L.lm_head_specs(V))
    return params


def _layer_specs(cfg, i: int) -> Params:
    mixer, mlp_kind = _parse(cfg.layer_entry(i))
    p: Params = {"norm1": L.norm_specs(cfg.norm_type),
                 "mixer": (L.attention_specs(cfg) if mixer == "attn"
                           else mamba2.mamba_specs(cfg))}
    if mlp_kind != "none":
        p["norm2"] = L.norm_specs(cfg.norm_type)
        p["mlp"] = (moe_lib.moe_specs(cfg.mlp_type) if mlp_kind == "moe"
                    else L.mlp_specs(cfg.mlp_type))
    return p


def param_specs(cfg) -> Params:
    """Partition specs of :func:`init_params`'s tree."""
    specs: Params = {"embed": L.embed_specs(cfg.vocab_size),
                     "final_norm": L.norm_specs(cfg.norm_type),
                     "layers": [_layer_specs(cfg, i)
                                for i in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.lm_head_specs(cfg.vocab_size)
    return specs


def normal_init(seed: int, dev: torch.device, dtype):
    """``normal(shape, std, out_dtype=None)``: N(0, std²) drawn in fp32
    by a generator on ``dev`` seeded with ``seed``, cast to ``out_dtype``
    (``dtype`` by default); on the meta device an empty tensor of that
    shape and dtype (a meta device has no generator)."""
    if dev.type == "meta":
        def normal(shape, std, out_dtype=None):
            return torch.empty(shape, dtype=out_dtype or dtype, device=dev)
        return normal
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std, out_dtype=None):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (t * std).to(out_dtype or dtype)
    return normal


def _parse(entry: str) -> Tuple[str, str]:
    """A pattern entry's (mixer, MLP): ``"mamba+none"`` -> ("mamba",
    "none")."""
    mixer, _, mlp = entry.partition("+")
    return mixer, (mlp or "none")


def resolve_backend(cfg, paged_backend: Optional[str], device):
    """``cfg`` with ``paged_backend`` settled: the call's override, else the
    config's, else ``"cuda"`` on a card and ``"torch"`` on the CPU.  The CPU
    allows only ``"torch"``, for serving and training alike.  The meta
    device walks the card's path (``"cuda"``: the kernels' meta routes)
    unless asked for ``"torch"``."""
    kind = torch.device(device).type
    backend = paged_backend or cfg.paged_backend or (
        "cuda" if kind in ("cuda", "meta") else "torch")
    if backend not in PAGED_BACKENDS:
        raise ValueError(f"unknown paged_backend {backend!r}")
    if backend == "cuda" and kind not in ("cuda", "meta"):
        raise ValueError("paged_backend='cuda' runs the CUDA kernels and "
                         "needs tensors on a card; the CPU allows only "
                         "'torch'")
    if backend == cfg.paged_backend:
        return cfg
    return cfg.with_overrides(paged_backend=backend)


def embed_tokens(embed, tokens, cfg, tp=None) -> torch.Tensor:
    """Rows of ``embed`` for ``tokens`` in the activations' dtype: the
    vocabulary-parallel lookup (one sum over the group) where ``tp``
    splits the vocabulary, else a plain lookup of the whole table."""
    if tp is not None and tpl.vocab_split(cfg, tp.size):
        return tpl.vocab_parallel_embed(embed, tokens, tp).to(
            torch_dtype(cfg.dtype))
    return embed[tokens.long()].to(torch_dtype(cfg.dtype))


def logits_of(x, head, cfg, tp=None) -> torch.Tensor:
    """fp32 logits of the final-normed ``x`` through ``head`` (d, V):
    where ``tp`` splits the vocabulary the rank's block (its input enters
    the group: each rank's gradient of ``x`` is a partial); else the whole
    logits, and ``x`` does not enter the group, since every rank already
    holds its whole gradient."""
    if tp is not None and tpl.vocab_split(cfg, tp.size):
        x = tpl.copy_to_group(x, tp)
    return L.matmul(x, head, out_dtype=torch.float32)


def _embed(params, tokens, cfg, tp=None):
    x = embed_tokens(params["embed"], tokens, cfg, tp)
    if cfg.family == "dense" and cfg.tie_embeddings:   # gemma-style scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(params, x, cfg, tp=None):
    """Logits (fp32); with ``tp`` this rank's block of the vocabulary, or
    the whole logits where the group does not split it."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return logits_of(x, head, cfg, tp)


def _apply_layer(i, lp, x, cfg, positions, adapters, lora_scale, cache=None,
                 adapter_ids=None, paged=None, n_new=None, tp=None, dp=None,
                 need_aux=True):
    """Layer ``i``: its mixer (attention, or a mamba block, which reads
    ``n_new``, the valid leading tokens of each row of a ragged prefill
    chunk), then the dense MLP or the MoE layer its pattern entry names,
    or none.  With ``tp`` (attention, a mamba block, the dense MLP and
    the experts) each block's input enters the model group through
    ``copy_to_group``;
    ``dp`` (a data group) and ``need_aux`` reach the MoE layer
    (``moe.apply_moe``); in a model with MoE layers ``dp`` also syncs a
    paged pool's scratch block over the group (``layers.sync_scratch``),
    since the positions that read it are routed too.  Returns (x, new
    cache, aux loss or None where the layer has no MoE)."""
    mixer, mlp = _parse(cfg.layer_entry(i))
    ad = adapters or {}
    h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
    if tp is not None:
        h = tpl.copy_to_group(h, tp)
    if mixer == "attn":
        out, new_cache = L.multihead_attention(
            lp["mixer"], h, cfg, positions, ad.get("mixer"), lora_scale,
            kv_cache=cache, adapter_ids=adapter_ids, paged=paged, tp=tp,
            scratch=dp if cfg.has_moe() else None)
    else:
        out, new_cache = mamba2.apply_mamba(
            lp["mixer"], h, cfg, ad.get("mixer"), lora_scale,
            ssm_cache=cache, adapter_ids=adapter_ids, n_new=n_new, tp=tp)
    x = x + out
    aux = None
    if mlp != "none":
        h = L.apply_norm(lp["norm2"], x, cfg.norm_type)
        if tp is not None:
            h = tpl.copy_to_group(h, tp)
        if mlp == "moe":
            out, aux = moe_lib.apply_moe(lp["mlp"], h, cfg, ad.get("mlp"),
                                         lora_scale, adapter_ids, tp=tp,
                                         dp=dp, need_aux=need_aux)
        else:
            out = L.apply_mlp(lp["mlp"], h, cfg.mlp_type, ad.get("mlp"),
                              lora_scale, adapter_ids, cfg.paged_backend,
                              tp=tp)
        x = x + out
    return x, new_cache, aux


# the "dots" policy's saved ops: products without batch dims, as the
# reference's ``dots_with_no_batch_dims_saveable`` saves them (the LoRA
# kernel's operator computes x·W + s·(x·A)·B over the rows)
_DOTS_SAVED = (torch.ops.aten.mm, torch.ops.aten.addmm,
               lora_matmul_op._opoverload._overloadpacket)


def _dots_policy(ctx, op, *args, **kwargs):
    if getattr(op, "_overloadpacket", None) in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# remat_policy -> the checkpoint's context_fn
_REMAT_CONTEXTS = {
    "full": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy)}


def _layer_adapters(adapters, i):
    return adapters["layers"][i] if adapters is not None else None


def forward(params: Params, tokens: torch.Tensor, cfg,
            adapters: Optional[Params] = None, lora_scale: float = 1.0,
            last_only: bool = False,
            adapter_ids: Optional[torch.Tensor] = None,
            paged_backend: Optional[str] = None,
            extra_embeds: Optional[torch.Tensor] = None, tp=None, dp=None,
            need_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32 (B, 1, V with
    ``last_only``), the MoE layers' aux losses summed: an fp32 scalar, 0
    for a model without MoE layers).  ``adapter_ids`` (B,) routes rows into a banked
    ``adapters`` tree (leaves (C, d_in, r)).  ``extra_embeds`` (B, P, d)
    (a VLM's image patches) are cast to the activations' dtype and
    prepended to the embedded text: the logits then cover P + S positions,
    the patches at RoPE positions 0..P-1.

    ``tp`` (``models/tensor_parallel.ModelGroup``): the params and
    adapters are this rank's shards under ``param_specs`` and
    ``core/lora.adapter_specs``, and the logits (B, S, V / size) its
    block of the vocabulary, or (B, S, V) where the group does not split
    it (``tensor_parallel.vocab_split``); a VLM's patch embeddings are
    whole on every rank.  ``dp``
    (``tensor_parallel.DataGroup``): ``tokens`` are this rank's rows of a
    batch the group splits, which an MoE layer's capacity and aux loss
    span; ``need_aux=False`` skips the aux loss's sum over it (the aux
    loss then comes back 0 there).

    With ``cfg.remat`` and grad enabled (a train step), each period of
    ``len(cfg.layer_pattern)`` layers runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint`` wraps its period body: the period keeps only its
    input ``(x, aux)`` and recomputes its activations in its backward.
    ``cfg.remat_policy`` "full" recomputes every op; "dots" saves the
    products without batch dims (``aten.mm``/``addmm``, the LoRA kernel's
    ``repro_torch::lora_matmul``) and recomputes the rest (attention, the
    expert bmm, the SSD scan, norms, activations, the collectives).  A
    recomputed period issues its forward's collectives again, and an
    open ``moe.RoutingLog`` replays the routing of the forward it
    repeats.  Under ``torch.no_grad`` (evaluation, the dry run's serving
    walks) nothing is checkpointed."""
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    x = _embed(params, tokens, cfg, tp)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=tokens.device)
    aux = torch.zeros((), device=tokens.device)
    n, period = len(params["layers"]), len(cfg.layer_pattern)

    def period_body(i0, x, aux):
        for i in range(i0, min(i0 + period, n)):
            x, _, a = _apply_layer(i, params["layers"][i], x, cfg, positions,
                                   _layer_adapters(adapters, i), lora_scale,
                                   adapter_ids=adapter_ids, tp=tp, dp=dp,
                                   need_aux=need_aux)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    for i0 in range(0, n, period):
        body = functools.partial(period_body, i0)
        if remat:
            x, aux = checkpoint(moe_lib.replays_routing(body), x, aux,
                                use_reentrant=False, preserve_rng_state=False,
                                context_fn=_REMAT_CONTEXTS[cfg.remat_policy])
        else:
            x, aux = body(x, aux)
    if last_only:
        x = x[:, -1:]
    return _unembed(params, x, cfg, tp), aux


def _is_mamba(cfg, i: int) -> bool:
    return _parse(cfg.layer_entry(i))[0] == "mamba"


def init_decode_cache(cfg, batch: int, cache_len: int,
                      device="cuda", tp=None) -> Params:
    """Fixed-path cache, on the card unless the caller asks for the CPU:
    per attention layer one bf16 ring buffer ``cache_len`` long (the full
    context for dense attention; the window for sliding-window archs,
    where it wraps), per mamba layer ``batch`` rows of recurrent state.
    With ``tp`` the ring buffers hold the rank's kv heads and the
    recurrent state its SSM heads (``decode_cache_specs``)."""
    dev = resolve_device(device)
    eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
           else cache_len)
    return {"layers": [
        mamba2.init_ssm_cache(cfg, batch, dev, tp) if _is_mamba(cfg, i)
        else L.init_kv_cache(cfg, batch, eff, torch.bfloat16, dev, tp=tp)
        for i in range(cfg.n_layers)]}


def decode_cache_specs(cfg) -> Params:
    """Partition specs of :func:`init_decode_cache`'s tree."""
    return {"layers": [mamba2.ssm_cache_specs(cfg) if _is_mamba(cfg, i)
                       else L.kv_cache_specs() for i in range(cfg.n_layers)]}


def paged_decode_cache_specs(cfg, kv_dtype: str = "f32") -> Params:
    """Partition specs of :func:`init_paged_decode_cache`'s tree."""
    return {"layers": [mamba2.ssm_cache_specs(cfg) if _is_mamba(cfg, i)
                       else L.paged_kv_cache_specs(kv_dtype)
                       for i in range(cfg.n_layers)]}


def init_paged_decode_cache(cfg, num_blocks: int, block_size: int,
                            device="cuda", kv_dtype: str = "f32",
                            num_slots: Optional[int] = None,
                            tp=None) -> Params:
    """Serving cache, on the card unless the caller asks for the CPU: per
    attention layer one K/V block pool shared by every slot (bf16 even
    when the model computes in fp32, as in the reference; int8 with
    ``kv_dtype="int8"``), per mamba layer a row of recurrent state for
    each of ``num_slots`` slots (required when the model has mamba
    layers; row i is slot i, reset on admission by
    ``serving/kv_cache.reset_slot``).  With ``tp`` the pools (and an int8
    pool's scales) hold the rank's kv heads and the recurrent state its
    SSM heads (``paged_decode_cache_specs``)."""
    dev = resolve_device(device)
    if num_slots is None and cfg.has_mixer("mamba"):
        raise ValueError(f"{cfg.name}: a model with mamba layers keeps "
                         "recurrent state per serving slot; pass num_slots")
    return {"layers": [
        mamba2.init_ssm_cache(cfg, num_slots, dev, tp) if _is_mamba(cfg, i)
        else L.init_paged_kv_cache(cfg, num_blocks, block_size,
                                   torch.bfloat16, dev, kv_dtype=kv_dtype,
                                   tp=tp)
        for i in range(cfg.n_layers)]}


def _cached_scan(params, cache, tokens, positions, cfg, adapters, lora_scale,
                 adapter_ids, paged, n_new=None, tp=None, dp=None
                 ) -> Tuple[torch.Tensor, Params]:
    """Embed, every layer against its cache, final norm, unembed (the MoE
    aux loss is dropped, as in the reference, so a data group never sums
    it).  With ``tp`` the logits are the rank's block of the
    vocabulary (whole where the group does not split it)."""
    x = _embed(params, tokens, cfg, tp)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        x, nc, _ = _apply_layer(i, lp, x, cfg, positions,
                                _layer_adapters(adapters, i), lora_scale,
                                cache=cache["layers"][i],
                                adapter_ids=adapter_ids, paged=paged,
                                n_new=n_new, tp=tp, dp=dp, need_aux=False)
        new_layers.append(nc)
    return _unembed(params, x, cfg, tp), {"layers": new_layers}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos: torch.Tensor, cfg, adapters: Optional[Params] = None,
                lora_scale: float = 1.0,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                paged_backend: Optional[str] = None, tp=None, dp=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step, tokens (B, 1).  Paged (continuous batching): pass
    ``block_tables`` (B, MB) and per-row context lengths ``pos`` (B,) over
    a cache from :func:`init_paged_decode_cache`.  Contiguous (the fixed
    path): ``block_tables`` None, ``pos`` an int, the tokens already in a
    cache from :func:`init_decode_cache`.  Returns (logits (B, 1, V),
    cache).  ``tp`` (``models/tensor_parallel.ModelGroup``): params,
    adapters and cache are this rank's shards, the logits (B, 1, V /
    size) its block of the vocabulary (whole where the group does not
    split it).  ``dp``
    (``tensor_parallel.DataGroup``): the rows are this rank's block of
    the serving slots, which an MoE layer's capacity spans."""
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    if block_tables is None:
        positions = torch.full((1,), int(pos), device=tokens.device)
        return _cached_scan(params, cache, tokens, positions, cfg, adapters,
                            lora_scale, adapter_ids, paged=None, tp=tp,
                            dp=dp)
    pos = pos.to(torch.int32)
    return _cached_scan(params, cache, tokens, pos[:, None].long(), cfg,
                        adapters, lora_scale, adapter_ids,
                        paged=(block_tables, pos), tp=tp, dp=dp)


def prefill_step(params: Params, cache: Params, tokens: torch.Tensor,
                 pos: torch.Tensor, n_new: torch.Tensor, cfg,
                 adapters: Optional[Params] = None, lora_scale: float = 1.0,
                 adapter_ids: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 paged_backend: Optional[str] = None, tp=None, dp=None
                 ) -> Tuple[torch.Tensor, Params]:
    """Chunked paged prefill: tokens (B, T), ``n_new[b]`` valid per row,
    written at positions ``pos[b] .. pos[b] + n_new[b] - 1`` (a mamba
    layer steps each row's state through its valid tokens only).  Returns
    (logits (B, T, V), cache); with ``tp`` and ``dp`` as
    :func:`decode_step`."""
    if block_tables is None:
        raise ValueError("prefill_step requires block_tables (paged cache)")
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    T = tokens.shape[1]
    pos = pos.to(torch.int32)
    n_new = n_new.to(torch.int32)
    positions = (pos.long()[:, None]
                 + torch.arange(T, device=tokens.device)[None, :])
    return _cached_scan(params, cache, tokens, positions, cfg, adapters,
                        lora_scale, adapter_ids,
                        paged=(block_tables, pos, n_new), n_new=n_new,
                        tp=tp, dp=dp)


"""Decoder: init, forward and the paged serving steps.

Port of the dense and MoE families of ``repro/models/model.py``.
Parameters are a plain dict: ``embed`` (V, d), ``final_norm``, ``layers``
(one dict per layer: ``norm1``, ``mixer`` {wq, wk, wv, wo}, ``norm2``,
``mlp``: the dense MLP of an attn+mlp layer, or the fp32 router and the
expert stacks (E, d_in, d_out) of an attn+moe one) and, untied,
``lm_head`` (d, V).  The reference stacks layers on a period axis for
``lax.scan``; here a Python loop walks the list.  Adapter trees and banks
follow the same per-layer layout (``core/lora.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PAGED_BACKENDS, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

Params = Dict[str, Any]


def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``seed``: the reference's init scales (normal ×
    d^-0.5 for projections and the fp32 router, × d_ff^-0.5 for w_out,
    × 0.02 for embeddings), drawn by a ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def normal(shape, std, out_dtype=None):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (t * std).to(out_dtype or dtype)

    def norm():
        if cfg.norm_type == "nonparametric":
            return {}
        p = {"scale": torch.ones(d, device=dev)}
        if cfg.norm_type == "layernorm":
            p["bias"] = torch.zeros(d, device=dev)
        return p

    layers = []
    for i in range(cfg.n_layers):
        if cfg.layer_entry(i).endswith("+moe"):
            mlp = moe_lib.init_moe(normal, d, cfg.resolved_d_ff_moe,
                                   cfg.n_experts, cfg.mlp_type)
        else:
            mlp = {"w_up": normal((d, ff), d ** -0.5),
                   "w_out": normal((ff, d), ff ** -0.5)}
            if cfg.mlp_type in ("swiglu", "geglu"):
                mlp["w_gate"] = normal((d, ff), d ** -0.5)
        layers.append({
            "norm1": norm(),
            "mixer": {"wq": normal((d, H * hd), d ** -0.5),
                      "wk": normal((d, Kv * hd), d ** -0.5),
                      "wv": normal((d, Kv * hd), d ** -0.5),
                      "wo": normal((H * hd, d), d ** -0.5)},
            "norm2": norm(), "mlp": mlp})
    params = {"embed": normal((V, d), 0.02), "final_norm": norm(),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), 0.02)
    return params


def resolve_backend(cfg, paged_backend: Optional[str], device):
    """``cfg`` with ``paged_backend`` settled: the call's override, else the
    config's, else ``"cuda"`` on a card and ``"torch"`` on the CPU.  The CPU
    allows only ``"torch"``, for serving and training alike."""
    backend = paged_backend or cfg.paged_backend or (
        "cuda" if torch.device(device).type == "cuda" else "torch")
    if backend not in PAGED_BACKENDS:
        raise ValueError(f"unknown paged_backend {backend!r}")
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError("paged_backend='cuda' runs the CUDA kernels and "
                         "needs tensors on a card; the CPU allows only "
                         "'torch'")
    if backend == cfg.paged_backend:
        return cfg
    return cfg.with_overrides(paged_backend=backend)


def _embed(params, tokens, cfg):
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.family == "dense" and cfg.tie_embeddings:   # gemma-style scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def _unembed(params, x, cfg):
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.matmul(x, head, out_dtype=torch.float32)


def _apply_layer(i, lp, x, cfg, positions, adapters, lora_scale, cache=None,
                 adapter_ids=None, paged=None):
    """Layer ``i``: attention, then the dense MLP or the MoE layer its
    pattern entry names.  Returns (x, new cache, aux loss or None for a
    dense layer)."""
    ad = adapters or {}
    h = L.apply_norm(lp["norm1"], x, cfg.norm_type)
    out, new_cache = L.multihead_attention(
        lp["mixer"], h, cfg, positions, ad.get("mixer"), lora_scale,
        kv_cache=cache, adapter_ids=adapter_ids, paged=paged)
    x = x + out
    h = L.apply_norm(lp["norm2"], x, cfg.norm_type)
    if cfg.layer_entry(i).endswith("+moe"):
        out, aux = moe_lib.apply_moe(lp["mlp"], h, cfg, ad.get("mlp"),
                                     lora_scale, adapter_ids)
    else:
        out = L.apply_mlp(lp["mlp"], h, cfg.mlp_type, ad.get("mlp"),
                          lora_scale, adapter_ids, cfg.paged_backend)
        aux = None
    return x + out, new_cache, aux


def _layer_adapters(adapters, i):
    return adapters["layers"][i] if adapters is not None else None


def forward(params: Params, tokens: torch.Tensor, cfg,
            adapters: Optional[Params] = None, lora_scale: float = 1.0,
            last_only: bool = False,
            adapter_ids: Optional[torch.Tensor] = None,
            paged_backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32 (B, 1, V with
    ``last_only``), the MoE layers' aux losses summed: an fp32 scalar, 0
    for a dense model).  ``adapter_ids`` (B,) routes rows into a banked
    ``adapters`` tree (leaves (C, d_in, r))."""
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=tokens.device)
    aux = torch.zeros((), device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        x, _, a = _apply_layer(i, lp, x, cfg, positions,
                               _layer_adapters(adapters, i), lora_scale,
                               adapter_ids=adapter_ids)
        if a is not None:
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    return _unembed(params, x, cfg), aux


def init_decode_cache(cfg, batch: int, cache_len: int,
                      device="cuda") -> Params:
    """Fixed-path cache: one bf16 ring buffer per layer, ``cache_len`` long
    (the full context for dense attention; the window for sliding-window
    archs, where it wraps), on the card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
           else cache_len)
    return {"layers": [L.init_kv_cache(cfg, batch, eff, torch.bfloat16, dev)
                       for _ in range(cfg.n_layers)]}


def init_paged_decode_cache(cfg, num_blocks: int, block_size: int,
                            device="cuda", kv_dtype: str = "f32") -> Params:
    """Serving cache: one bf16 K/V block pool per layer (bf16 even when the
    model computes in fp32, as in the reference), on the card unless the
    caller asks for the CPU."""
    dev = resolve_device(device)
    return {"layers": [L.init_paged_kv_cache(cfg, num_blocks, block_size,
                                             torch.bfloat16, dev,
                                             kv_dtype=kv_dtype)
                       for _ in range(cfg.n_layers)]}


def _cached_scan(params, cache, tokens, positions, cfg, adapters, lora_scale,
                 adapter_ids, paged) -> Tuple[torch.Tensor, Params]:
    """Embed, every layer against its pool, final norm, unembed (the MoE
    aux loss is dropped, as in the reference)."""
    x = _embed(params, tokens, cfg)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        x, nc, _ = _apply_layer(i, lp, x, cfg, positions,
                                _layer_adapters(adapters, i), lora_scale,
                                cache=cache["layers"][i],
                                adapter_ids=adapter_ids, paged=paged)
        new_layers.append(nc)
    return _unembed(params, x, cfg), {"layers": new_layers}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos: torch.Tensor, cfg, adapters: Optional[Params] = None,
                lora_scale: float = 1.0,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                paged_backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step, tokens (B, 1).  Paged (continuous batching): pass
    ``block_tables`` (B, MB) and per-row context lengths ``pos`` (B,) over
    a cache from :func:`init_paged_decode_cache`.  Contiguous (the fixed
    path): ``block_tables`` None, ``pos`` an int, the tokens already in a
    cache from :func:`init_decode_cache`.  Returns (logits (B, 1, V),
    cache)."""
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    if block_tables is None:
        positions = torch.full((1,), int(pos), device=tokens.device)
        return _cached_scan(params, cache, tokens, positions, cfg, adapters,
                            lora_scale, adapter_ids, paged=None)
    pos = pos.to(torch.int32)
    return _cached_scan(params, cache, tokens, pos[:, None].long(), cfg,
                        adapters, lora_scale, adapter_ids,
                        paged=(block_tables, pos))


def prefill_step(params: Params, cache: Params, tokens: torch.Tensor,
                 pos: torch.Tensor, n_new: torch.Tensor, cfg,
                 adapters: Optional[Params] = None, lora_scale: float = 1.0,
                 adapter_ids: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 paged_backend: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """Chunked paged prefill: tokens (B, T), ``n_new[b]`` valid per row,
    written at positions ``pos[b] .. pos[b] + n_new[b] - 1``.  Returns
    (logits (B, T, V), cache)."""
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
                        paged=(block_tables, pos, n_new))


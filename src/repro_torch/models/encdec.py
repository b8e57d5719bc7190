"""Whisper-style encoder-decoder: init, training forward and decode.

Port of ``repro/models/encdec.py``.  The modality frontend (mel
spectrogram and convolutions) is a stub, as in the reference: callers pass
frame embeddings ``enc_embeds`` (B, T, d) with T <= ``encoder_seq_len``.
Whisper's flavour: learned positions (no RoPE), pre-LayerNorm with bias,
a GELU MLP without a gate, a tied unembedding.

Parameters follow the reference's tree: ``embed`` (V, d), ``enc_pos``
(encoder_seq_len, d), ``dec_pos`` (max_seq_len, d), ``enc_blocks`` and
``dec_blocks`` (each leaf stacked over its own depth: ``self_attn``,
``mlp``, ``norm1``, ``norm2``; the decoder adds ``cross_attn`` and
``norm3``), ``enc_final_norm`` and ``dec_final_norm``; ``param_specs`` and
``decode_cache_specs`` are the reference's partition specs of both
trees.  Adapter trees stack
the same way (``core/lora.py``).  A Python loop walks the layers, each
reading its slice of the stacks.

The encoder's self-attention and every cross-attention attend without a
mask (``causal=False``: the flash-attention kernel's non-causal mode on
``"cuda"``); the decoder's self-attention is causal, through the kernel in
training and through the fixed path's ring buffer in decode.  Cross
K/V come from plain products of the encoder's output with ``wk``/``wv``:
the cross-attention's ``wk``/``wv`` adapters are never read, so a
``cross_attn.wv`` adapter gets a zero gradient, as in the reference.

With a model group (``tp``, ``models/tensor_parallel.py``) every block
runs on the rank's shard, as the decoder families' do: each attention
(the encoder's, the decoder's self- and cross-attention) its heads and kv
heads, column-parallel ``wq``/``wk``/``wv`` and row-parallel ``wo``, the
GELU MLP its ff columns, each block's input entering the group through
``copy_to_group``.  The encoder's output enters the group once: every
decoder layer's cross K/V are the rank's kv heads (its columns of the
cross-attention's ``wk``/``wv``), each a partial of that output's
gradient, summed in that one backward.  The tied unembedding is
vocabulary-parallel where the axis divides the vocabulary and whole on
every rank where it does not (``tensor_parallel.vocab_split``): whisper's
51,865 entries stay whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import torch_dtype
from repro_torch.core.partition import P, add_leading, spec_map
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.model import (embed_tokens, logits_of, normal_init,
                                      resolve_backend)

Params = Dict[str, Any]


def init_params(cfg, seed: int = 0, device="cuda", shard=None) -> Params:
    """Random weights from ``seed`` at the reference's init scales (normal
    × d^-0.5 for projections, × d_ff^-0.5 for ``w_out``, × 0.02 for the
    embedding and both position tables; fp32 norms at 1 and 0), drawn by
    a ``torch.Generator`` on ``device`` (on the meta device: the same
    shapes and dtypes, no values).  ``shard`` (size, rank): rank
    ``rank``'s shard of a ``size``-way model axis under
    :func:`param_specs`, each leaf drawn whole and cut as it is drawn, so
    a rank's values are its block of the whole tree's."""
    if shard is not None:
        tpl.check_model_axis(cfg, shard[0])
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    normal = normal_init(seed, dev, dtype)

    specs = param_specs(cfg)

    def cut(tree, spec):
        if shard is None:
            return tree
        return spec_map(lambda s, t: tpl.shard_leaf(t, s, *shard), spec,
                        tree)

    def attn(n, spec):
        return cut({"wq": normal((n, d, H * hd), d ** -0.5),
                    "wk": normal((n, d, Kv * hd), d ** -0.5),
                    "wv": normal((n, d, Kv * hd), d ** -0.5),
                    "wo": normal((n, H * hd, d), d ** -0.5)}, spec)

    def mlp(n, spec):
        p = {"w_up": normal((n, d, ff), d ** -0.5),
             "w_out": normal((n, ff, d), ff ** -0.5)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            p["w_gate"] = normal((n, d, ff), d ** -0.5)
        return cut(p, spec)

    def norm(*lead):
        if cfg.norm_type == "nonparametric":
            return {}
        p = {"scale": torch.ones(*lead, d, device=dev)}
        if cfg.norm_type == "layernorm":
            p["bias"] = torch.zeros(*lead, d, device=dev)
        return p

    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    enc, dec = specs["enc_blocks"], specs["dec_blocks"]
    return {
        "embed": cut(normal((V, d), 0.02), specs["embed"]),
        "enc_pos": normal((cfg.encoder_seq_len, d), 0.02),
        "dec_pos": normal((cfg.max_seq_len, d), 0.02),
        "enc_blocks": {"self_attn": attn(Le, enc["self_attn"]),
                       "mlp": mlp(Le, enc["mlp"]),
                       "norm1": norm(Le), "norm2": norm(Le)},
        "dec_blocks": {"self_attn": attn(Ld, dec["self_attn"]),
                       "cross_attn": attn(Ld, dec["cross_attn"]),
                       "mlp": mlp(Ld, dec["mlp"]), "norm1": norm(Ld),
                       "norm2": norm(Ld), "norm3": norm(Ld)},
        "enc_final_norm": norm(),
        "dec_final_norm": norm(),
    }


def param_specs(cfg) -> Params:
    """Partition specs of :func:`init_params`'s tree: each block's leaves
    with a replicated depth entry first."""
    norm = L.norm_specs(cfg.norm_type)
    enc = {"self_attn": L.attention_specs(cfg),
           "mlp": L.mlp_specs(cfg.mlp_type), "norm1": norm, "norm2": norm}
    dec = {"self_attn": L.attention_specs(cfg),
           "cross_attn": L.attention_specs(cfg),
           "mlp": L.mlp_specs(cfg.mlp_type), "norm1": norm, "norm2": norm,
           "norm3": norm}
    return {"embed": L.embed_specs(cfg.vocab_size), "enc_pos": P(None, None),
            "dec_pos": P(None, None), "enc_blocks": add_leading(enc),
            "dec_blocks": add_leading(dec), "enc_final_norm": norm,
            "dec_final_norm": norm}


def decode_cache_specs(cfg) -> Params:
    """Partition specs of :func:`init_decode_cache`'s tree; the ring
    buffers' write count is one replicated int here (the reference stacks
    it over depth)."""
    cross = P(None, L.DATA, None, L.MODEL, None)
    return {"self": dict(add_leading(L.kv_cache_specs()), pos=P()),
            "cross_k": cross, "cross_v": cross}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (params or adapters; None stays
    None).  A dual adapter's fusion weights ``w`` (2,) are shared by every
    layer and pass whole."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (v if k == "w" else _layer(v, i)) for k, v in tree.items()}
    return tree[i]


def _enter(h: torch.Tensor, tp) -> torch.Tensor:
    """A column-parallel block's input (``copy_to_group``), or ``h``."""
    return h if tp is None else tpl.copy_to_group(h, tp)


def encode(params: Params, enc_embeds: torch.Tensor, cfg,
           adapters: Optional[Params] = None,
           lora_scale: float = 1.0, tp=None) -> torch.Tensor:
    """enc_embeds (B, T, d) -> encoder output (B, T, d) in the activations'
    dtype: positions added, then every encoder layer (self-attention
    without a mask, MLP), then the final norm.  ``cfg.paged_backend`` must
    be resolved (``forward`` and ``prefill_cross`` do it).  With ``tp``
    each block on the rank's heads and ff columns, its partials summed
    over the group; the output is whole on every rank."""
    dtype = torch_dtype(cfg.dtype)
    T = enc_embeds.shape[1]
    x = enc_embeds.to(dtype) + params["enc_pos"][:T].to(dtype)[None]
    positions = torch.arange(T, device=x.device)
    blocks, ad = params["enc_blocks"], (adapters or {}).get("enc_blocks")
    for i in range(cfg.n_encoder_layers):
        lp, la = _layer(blocks, i), _layer(ad, i) or {}
        h = _enter(L.apply_norm(lp["norm1"], x, cfg.norm_type), tp)
        out, _ = L.multihead_attention(lp["self_attn"], h, cfg, positions,
                                       la.get("self_attn"), lora_scale,
                                       causal=False, tp=tp)
        x = x + out
        h = _enter(L.apply_norm(lp["norm2"], x, cfg.norm_type), tp)
        x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, la.get("mlp"),
                            lora_scale, backend=cfg.paged_backend, tp=tp)
    return L.apply_norm(params["enc_final_norm"], x, cfg.norm_type)


def _cross_kv(block: Params, enc_out: torch.Tensor, cfg,
              tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V (B, T, Kv, hd): plain products of the
    encoder output with the cross-attention's ``wk``/``wv`` (no adapter,
    as in the reference); with ``tp`` the rank's kv heads (its columns
    of ``wk``/``wv``)."""
    B, T, _ = enc_out.shape
    Kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if tp is not None:
        Kv //= tp.size
    k = L.matmul(enc_out, block["cross_attn"]["wk"]).reshape(B, T, Kv, hd)
    v = L.matmul(enc_out, block["cross_attn"]["wv"]).reshape(B, T, Kv, hd)
    return k, v


def _decoder_stack(params: Params, x: torch.Tensor, positions, cfg,
                   enc_out=None, cross_kv=None, adapters=None,
                   lora_scale: float = 1.0, cache=None, tp=None):
    """The decoder's layers over x (B, S, d), reading either ``enc_out``
    (training: cross K/V computed per layer; with ``tp`` it has entered
    the group already) or ``cross_kv`` (decode: the stacked bf16 cache).
    ``cache``: the self-attention ring buffers {"k", "v": (L, B, S_cache,
    Kv, hd), "pos": int}, written in place.  With ``tp`` every block on
    the rank's heads and ff columns, caches and cross K/V at its kv
    heads.  Returns (x, the new self cache or None)."""
    blocks, ad = params["dec_blocks"], (adapters or {}).get("dec_blocks")
    pos = None
    for i in range(cfg.n_layers):
        lp, la = _layer(blocks, i), _layer(ad, i) or {}
        ring = None
        if cache is not None:
            ring = {"k": cache["k"][i], "v": cache["v"][i],
                    "pos": cache["pos"]}
        h = _enter(L.apply_norm(lp["norm1"], x, cfg.norm_type), tp)
        out, ring = L.multihead_attention(lp["self_attn"], h, cfg, positions,
                                          la.get("self_attn"), lora_scale,
                                          kv_cache=ring, tp=tp)
        x = x + out
        if ring is not None:
            pos = ring["pos"]
        h = _enter(L.apply_norm(lp["norm2"], x, cfg.norm_type), tp)
        if cross_kv is not None:
            ck, cv = cross_kv[0][i], cross_kv[1][i]
        else:
            ck, cv = _cross_kv(lp, enc_out, cfg, tp)
        out, _ = L.multihead_attention(
            lp["cross_attn"], h, cfg, positions, la.get("cross_attn"),
            lora_scale, causal=False,
            kv_override=(ck.to(h.dtype), cv.to(h.dtype)), tp=tp)
        x = x + out
        h = _enter(L.apply_norm(lp["norm3"], x, cfg.norm_type), tp)
        x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, la.get("mlp"),
                            lora_scale, backend=cfg.paged_backend, tp=tp)
    if cache is None:
        return x, None
    return x, {"k": cache["k"], "v": cache["v"], "pos": pos}


def _unembed(params: Params, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """fp32 logits through the tied embedding: with ``tp`` the rank's
    block of the vocabulary, or the whole where the group does not split
    it (``model.logits_of``)."""
    x = L.apply_norm(params["dec_final_norm"], x, cfg.norm_type)
    return logits_of(x, params["embed"].T, cfg, tp)


def _encoder_output(params, enc_embeds, cfg, adapters, lora_scale, tp):
    """The encoder's output as every decoder layer's cross K/V read it:
    with ``tp`` it enters the group once (each rank's cross K/V columns
    give it a partial gradient, summed in that one backward)."""
    return _enter(encode(params, enc_embeds, cfg, adapters, lora_scale, tp),
                  tp)


def _dec_embed(params, tokens, pos, cfg, tp):
    """The decoder's token embeddings (vocabulary-parallel where ``tp``
    splits the vocabulary) plus the learned positions ``pos``."""
    dtype = torch_dtype(cfg.dtype)
    return (embed_tokens(params["embed"], tokens, cfg, tp)
            + params["dec_pos"][pos].to(dtype))


def forward(params: Params, enc_embeds: torch.Tensor,
            dec_tokens: torch.Tensor, cfg,
            adapters: Optional[Params] = None, lora_scale: float = 1.0,
            paged_backend: Optional[str] = None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: frame embeddings (B, T, d) and decoder tokens
    (B, S) -> (logits (B, S, V) fp32, a zero fp32 aux loss).  ``tp``: the
    params and adapters are this rank's shards, the logits its block of
    the vocabulary (whole where the group does not split it)."""
    cfg = resolve_backend(cfg, paged_backend, dec_tokens.device)
    enc_out = _encoder_output(params, enc_embeds, cfg, adapters, lora_scale,
                              tp)
    S = dec_tokens.shape[1]
    x = _dec_embed(params, dec_tokens, slice(0, S), cfg, tp)
    positions = torch.arange(S, device=x.device)
    x, _ = _decoder_stack(params, x, positions, cfg, enc_out=enc_out,
                          adapters=adapters, lora_scale=lora_scale, tp=tp)
    return (_unembed(params, x, cfg, tp),
            torch.zeros((), device=dec_tokens.device))


def init_decode_cache(cfg, batch: int, cache_len: int,
                      device="cuda", tp=None) -> Params:
    """The fixed path's decode cache, bf16, on the card unless the caller
    asks for the CPU: the decoder's self-attention ring buffers ``self``
    {"k", "v": (L, batch, cache_len, Kv, hd), "pos": 0} and the cross K/V
    ``cross_k``/``cross_v`` (L, batch, encoder_seq_len, Kv, hd), zero
    until :func:`prefill_cross` fills them; with ``tp`` both at the
    rank's ``Kv / size`` kv heads (``decode_cache_specs``)."""
    dev = resolve_device(device)
    Kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if tp is not None:
        Kv //= tp.size
    nL, T = cfg.n_layers, cfg.encoder_seq_len

    def zeros(n):
        return torch.zeros((nL, batch, n, Kv, hd), dtype=torch.bfloat16,
                           device=dev)
    return {"self": {"k": zeros(cache_len), "v": zeros(cache_len), "pos": 0},
            "cross_k": zeros(T), "cross_v": zeros(T)}


def prefill_cross(params: Params, enc_embeds: torch.Tensor, cfg,
                  adapters: Optional[Params] = None, lora_scale: float = 1.0,
                  paged_backend: Optional[str] = None, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the encoder once and compute every decoder layer's cross K/V:
    (cross_k, cross_v), each (L, B, T, Kv, hd) bf16, for the decode
    cache; with ``tp`` the encoder on the rank's shards and only its kv
    heads' cross K/V (Kv / size)."""
    cfg = resolve_backend(cfg, paged_backend, enc_embeds.device)
    enc_out = _encoder_output(params, enc_embeds, cfg, adapters, lora_scale,
                              tp)
    kv = [_cross_kv(_layer(params["dec_blocks"], i), enc_out, cfg, tp)
          for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kv]).to(torch.bfloat16),
            torch.stack([v for _, v in kv]).to(torch.bfloat16))


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos: int, cfg, adapters: Optional[Params] = None,
                lora_scale: float = 1.0,
                paged_backend: Optional[str] = None, tp=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decoder step, tokens (B, 1) at position ``pos`` (the tokens
    already in the cache): its learned position is ``dec_pos[pos %
    max_seq_len]``.  Returns (logits (B, 1, V) fp32, cache); the ring
    buffers are written in place.  ``tp``: params, adapters and cache
    are this rank's shards, the logits its block of the vocabulary
    (whole where the group does not split it)."""
    cfg = resolve_backend(cfg, paged_backend, tokens.device)
    pos = int(pos)
    x = _dec_embed(params, tokens, pos % cfg.max_seq_len, cfg, tp)
    positions = torch.full((1,), pos, device=tokens.device)
    x, new_self = _decoder_stack(
        params, x, positions, cfg,
        cross_kv=(cache["cross_k"], cache["cross_v"]), adapters=adapters,
        lora_scale=lora_scale, cache=cache["self"], tp=tp)
    return _unembed(params, x, cfg, tp), {"self": new_self,
                                          "cross_k": cache["cross_k"],
                                          "cross_v": cache["cross_v"]}

"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Port of ``repro/models/moe.py``.  The dispatch is sort-based, as in the
reference:

  1. the router gives each token its top-k expert ids and weights,
  2. the T·k token copies are sorted by expert id (a stable sort),
  3. each copy's slot within its expert comes from its expert's segment
     start in the sorted order,
  4. copies scatter into a padded ``(E·cap + 1, d)`` buffer, copies past
     an expert's capacity to the last row, which is dropped,
  5. the expert FFN runs batched over the experts, ``(E, cap, d) @ (E,
     d, ff)``,
  6. outputs gather back and combine with the router weights.

Capacity counts every token of the dispatch, padding and idle slots
included (``T = B·S``), and earlier flat positions win slots first: a
request's output depends on the make-up of its batch, in the reference as
here.  Shapes depend only on (T, k, E), so the dispatch makes no host
round trip.  The routing, dispatch and expert products are plain torch on
both backends (plain jnp outside any kernel in the reference); the
router's LoRA goes through the plain ``layers.lora_delta``, as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.partition import P
from repro_torch.models.layers import (MODEL, DualPair, lora_delta, lora_pair,
                                       matmul)

Params = Dict[str, Any]


def init_moe(normal, d: int, ff: int, n_experts: int, mlp_type: str
             ) -> Params:
    """One MoE layer's weights with the reference's scales: ``normal(shape,
    std, out_dtype=None)`` draws (``out_dtype`` None: the parameter
    dtype).  The router stays fp32.  Expert stacks are drawn an expert at
    a time, so the fp32 draw of a stack (22.5 GB for one of kimi-k2's) is
    never held whole."""
    def stack(shape, std):
        first = normal(shape, std)
        out = first.new_empty((n_experts,) + shape)
        out[0] = first
        for e in range(1, n_experts):
            out[e] = normal(shape, std)
        return out

    p = {"router": normal((d, n_experts), d ** -0.5, torch.float32),
         "w_up": stack((d, ff), d ** -0.5),
         "w_out": stack((ff, d), ff ** -0.5)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = stack((d, ff), d ** -0.5)
    return p


def moe_specs(mlp_type: str) -> Params:
    """Experts on the model axis; the router replicated."""
    p = {"router": P(None, None),
         "w_up": P(MODEL, None, None),
         "w_out": P(MODEL, None, None)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = P(MODEL, None, None)
    return p


def capacity(T: int, k: int, E: int, factor: float) -> int:
    """Slots per expert: ``max(k, round(T·k/E·factor))`` (Python's round)
    rounded up to a multiple of 64, as the reference sizes it."""
    cap = int(max(k, round(T * k / E * factor)))
    return -(-cap // 64) * 64


def _top_k_routing(router_logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) -> weights (T, k), ids (T, k), the Switch load-balance aux
    loss.  Ties go to the lower expert id, as ``jax.lax.top_k`` breaks
    them (a stable descending sort cut to k)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    E = router_logits.shape[-1]
    density = torch.mean(F.one_hot(ids[:, 0], E).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * E
    return weights, ids, aux


def dispatch(ids: torch.Tensor, E: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (T, k) -> (dest (T·k,), keep (T·k,)): each copy's buffer row
    (``expert·cap + slot``; ``E·cap`` for a dropped copy) and whether it
    fits.  A copy's slot is its rank among its expert's copies in flat
    order (the stable sort keeps earlier tokens first)."""
    flat_ids = ids.reshape(-1)
    n = flat_ids.numel()
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(E, dtype=sorted_ids.dtype,
                                 device=ids.device))
    slot_sorted = (torch.arange(n, device=ids.device)
                   - seg_start[sorted_ids])
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = slot < cap
    dest = torch.where(keep, flat_ids * cap + slot,
                       torch.full_like(slot, E * cap))
    return dest, keep


class _BmmF32(torch.autograd.Function):
    """``aten::bmm.dtype`` (bf16 operands, fp32 result) with a backward,
    which autograd lacks for that overload: each operand's gradient is a
    bf16 product of the other operand and the fp32 output gradient
    rounded to bf16, accumulated in fp32 and returned in the operand's
    dtype, with no fp32 copy of an expert stack."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g.to(b.dtype), b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2), g.to(a.dtype),
                           out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b accumulated and returned in fp32 (the reference's
    ``preferred_element_type=float32``).  bf16 operands on a card use
    ``aten::bmm.dtype``, which multiplies bf16 into fp32 without an fp32
    copy of the expert stack (so does the meta device, which walks the
    card's path); elsewhere the operands go to fp32 (exact for bf16
    values)."""
    if (a.dtype != torch.float32 and (a.is_cuda or a.is_meta)
            and "dtype" in torch.ops.aten.bmm.overloads()):
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _router_delta(adapters, x, adapter_ids):
    """The router's fp32 LoRA update through the plain ``lora_delta`` on
    both backends (an Eq. 7 pair of pairs is merged first), or None."""
    lora = lora_pair(adapters, "router")
    if lora is None:
        return None
    if isinstance(lora, DualPair):
        lora = lora.merged()
    return lora_delta(x, lora.a, lora.b, adapter_ids, lora.a_scale,
                      lora.b_scale)


def apply_moe(params: Params, x: torch.Tensor, cfg,
              adapters: Optional[Params] = None, lora_scale: float = 1.0,
              adapter_ids: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 scalar).
    ``adapters`` may hold a ``"router"`` LoRA (the only MoE target; a
    bank with ``adapter_ids`` routes each row to its client's)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = B * S
    cap = capacity(T, k, E, cfg.moe_capacity_factor)

    xf = x.reshape(T, d)
    # the fp32 router cast to x's dtype, the product in fp32
    logits = matmul(xf, params["router"].to(x.dtype), out_dtype=torch.float32)
    delta = _router_delta(adapters, x, adapter_ids)
    if delta is not None:
        logits = logits + lora_scale * delta.reshape(T, E)
    weights, ids, aux = _top_k_routing(logits, k)

    dest, keep = dispatch(ids, E, cap)
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token_idx]         # dropped copies all land in the last row
    buf = buf[:E * cap].reshape(E, cap, d)

    w_up = params["w_up"].to(x.dtype)
    if "w_gate" in params:
        g = _bmm_f32(buf, params["w_gate"].to(x.dtype))
        u = _bmm_f32(buf, w_up)
        act = (F.silu(g) if cfg.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = (act * u).to(x.dtype)
    else:
        h = F.gelu(_bmm_f32(buf, w_up), approximate="tanh").to(x.dtype)
    y_buf = _bmm_f32(h, params["w_out"].to(x.dtype)).to(x.dtype)

    y_flat = torch.cat([y_buf.reshape(E * cap, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    # every token owns rows t·k .. t·k+k-1: sum its k copies in a fixed
    # order (no atomics), from 0 as the reference's scatter-add does
    y_copies = (y_flat[dest].float()
                * (weights.reshape(-1) * keep.float())[:, None]
                ).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + y_copies[:, j]
    return out.reshape(B, S, d).to(x.dtype), aux

"""Model-layout adapters over the kernel wrappers.

Port of ``repro/kernels/ops.py``.  The reference padded head dims, ranks
and matrix edges to its TPU tiles; the CUDA kernels take any width, so
nothing is padded here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.batched_lora import batched_lora_matmul
from repro_torch.kernels.dual_lora import dual_lora_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                               paged_scatter,
                                               paged_scatter_quant)


def lora_dense(x: torch.Tensor, w: torch.Tensor,
               adapter: Dict[str, torch.Tensor], scale: float) -> torch.Tensor:
    """(..., K) @ (K, N) plus the LoRA update of ``adapter`` = {"a": (K, r),
    "b": (r, N)}, through the fused kernel (differentiable)."""
    lead, K = x.shape[:-1], x.shape[-1]
    y = lora_matmul(x.reshape(-1, K).contiguous(), w, adapter["a"].contiguous(),
                    adapter["b"].contiguous(), scale)
    return y.reshape(*lead, w.shape[1])


def fused_dual_lora_dense(x: torch.Tensor, w: torch.Tensor,
                          ad_p: Dict[str, torch.Tensor],
                          ad_s: Dict[str, torch.Tensor],
                          fusion_w: torch.Tensor, scale: float) -> torch.Tensor:
    """Base plus the Eq. 7 merge of a personalized (``ad_p``) and a global
    (``ad_s``) pair at ``fusion_w`` (2,) fp32, in one kernel."""
    lead, K = x.shape[:-1], x.shape[-1]
    y = dual_lora_matmul(x.reshape(-1, K).contiguous(), w,
                         ad_p["a"].contiguous(), ad_p["b"].contiguous(),
                         ad_s["a"].contiguous(), ad_s["b"].contiguous(),
                         fusion_w, scale)
    return y.reshape(*lead, w.shape[1])


def concat_buckets(bank: Dict) -> Dict[str, torch.Tensor]:
    """A ragged bank's per-bucket lists concatenated on the client axis at
    the largest bucket rank (small buckets zero-padded), with ``ranks``
    (C,) int32: each slot's bucket rank, which the kernel's rank mask
    reads.  The reference's wrapper does this in every projection; the
    port's registry does it once per bank snapshot
    (``AdapterRegistry.kernel_bank``)."""
    pad = torch.nn.functional.pad
    r_max = max(a.shape[-1] for a in bank["a"])
    out = {"a": torch.cat([pad(a, (0, r_max - a.shape[-1]))
                           for a in bank["a"]]),
           "b": torch.cat([pad(b, (0, 0, 0, r_max - b.shape[1]))
                           for b in bank["b"]]),
           "ranks": torch.cat([torch.full((a.shape[0],), a.shape[-1],
                                          dtype=torch.int32,
                                          device=a.device)
                               for a in bank["a"]])}
    if bank.get("a_scale") is not None:
        out["a_scale"] = torch.cat(list(bank["a_scale"]))
        out["b_scale"] = torch.cat(list(bank["b_scale"]))
    return out


def batched_lora_dense(x: torch.Tensor, w: torch.Tensor, bank: Dict,
                       adapter_ids: torch.Tensor, scale: float) -> torch.Tensor:
    """Multi-tenant dense: x (B, ..., K) @ w (K, N) with per-request routing
    into ``bank`` = {"a": (C, K, r), "b": (C, r, N)} (int8 banks add
    ``a_scale``/``b_scale`` (C,); a per-slot ``ranks`` (C,) int32 masks rank
    columns).  A ragged bank's per-bucket lists are concatenated first
    (:func:`concat_buckets`).  ``adapter_ids`` (B,) broadcasts over the
    trailing axes of ``x``."""
    if isinstance(bank["a"], (list, tuple)):
        bank = concat_buckets(bank)
    lead = x.shape[:-1]
    K = x.shape[-1]
    rows_per_item = 1
    for s in lead[1:]:
        rows_per_item *= s
    g = torch.repeat_interleave(adapter_ids.to(torch.int32), rows_per_item)
    y = batched_lora_matmul(x.reshape(-1, K).contiguous(), w, bank["a"],
                            bank["b"], g, scale, a_scale=bank.get("a_scale"),
                            b_scale=bank.get("b_scale"),
                            ranks=bank.get("ranks"))
    return y.reshape(*lead, w.shape[1])


def paged_gqa_attention(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        sliding_window: int = 0) -> torch.Tensor:
    """Decode attention in model layout: q (B, 1, H, hd) or (B, H, hd).
    ``lengths`` is exclusive: in the serving decode step pass the pre-write
    position + 1, AFTER scattering the step's K/V, so the token being
    decoded attends itself (and, with ``sliding_window`` W, the W - 1
    positions before it).  Returns q's shape."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    o = paged_attention(q.contiguous(), k_pool, v_pool,
                        block_tables.to(torch.int32).contiguous(),
                        lengths.to(torch.int32).contiguous(),
                        k_scale=k_scale, v_scale=v_scale,
                        sliding_window=sliding_window)
    return o[:, None] if squeeze else o


def paged_prefill_gqa_attention(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, n_new: torch.Tensor, *,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                sliding_window: int = 0):
    """Chunk attention in model layout: scatter the chunk's K/V (B, T, Kv,
    hd) through the tables (ragged tails ``t >= n_new[b]`` to scratch block
    0), then run the prefill kernel over the updated pools (query t
    attending the ``sliding_window`` positions ending at its own, if W >
    0).  Returns
    (out (B, T, H, hd), k_pool, v_pool[, k_scale, v_scale]); pools are
    updated in place."""
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    quantized = k_scale is not None
    if quantized:
        kp, vp, ks, vs = paged_scatter_quant(k_pool, v_pool, k_scale, v_scale,
                                             k_new, v_new, bt, lens, n_new)
    else:
        kp, vp = paged_scatter(k_pool, v_pool, k_new, v_new, bt, lens, n_new)
        ks = vs = None
    o = paged_prefill_attention(q.contiguous(), kp, vp, bt, lens,
                                k_scale=ks, v_scale=vs,
                                sliding_window=sliding_window)
    if quantized:
        return o, kp, vp, ks, vs
    return o, kp, vp


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sliding_window: int = 0) -> torch.Tensor:
    """Model layout: q (B, Sq, H, d), k/v (B, Sk, Kv, d) -> (B, Sq, H, d).
    The kernel reads the (B, S, heads, d) tensors through strides and kv
    head ``h // (H // Kv)``, so nothing is transposed or repeated in memory;
    on the CPU the plain version repeats kv heads, as the reference's
    wrapper does."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        sliding_window=sliding_window)
    return o.transpose(1, 2)

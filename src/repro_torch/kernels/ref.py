"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each is the port of the reference package's oracle of the same name
(``repro/kernels/ref.py``).  The kernel wrappers run these for tensors on
the CPU; on a card they are only ever called to check a kernel.
"""
from __future__ import annotations

from typing import Optional

import torch


def lora_matmul_ref(x, w, a, b, scale: float):
    """``y = x @ w + scale * (x @ a) @ b``, fp32 accumulation, one rounding
    to ``x.dtype`` at the end."""
    base = torch.matmul(x.float(), w.float())
    z = torch.matmul(torch.matmul(x.float(), a.float()), b.float())
    return (base + scale * z).to(x.dtype)


def dual_lora_matmul_ref(x, w, a1, b1, a2, b2, w1, w2, scale: float):
    """Eq. 7 fused: ``y = x@w + scale·x@[(w1A1+w2A2)(w1B1+w2B2)]``, the
    merged factors in fp32, one rounding to ``x.dtype``."""
    am = (w1 * a1 + w2 * a2).float()
    bm = (w1 * b1 + w2 * b2).float()
    base = torch.matmul(x.float(), w.float())
    z = torch.matmul(torch.matmul(x.float(), am), bm)
    return (base + scale * z).to(x.dtype)


def batched_lora_matmul_ref(x, w, a, b, adapter_ids, scale: float, *,
                            a_scale=None, b_scale=None, ranks=None):
    """Multi-tenant LoRA: ``y[i] = x[i]@w + scale*(x[i]@a[g[i]])@b[g[i]]``.

    x: (M, K), w: (K, N), a: (C, K, r), b: (C, r, N), adapter_ids: (M,).
    int8 banks pass ``a_scale``/``b_scale`` ((C,) fp32); ragged banks pass
    ``ranks`` ((C,) int32) and rank columns at or past a row's rank are
    zeroed between the two products.  One rounding to ``x.dtype`` at the
    end."""
    ids = adapter_ids.long()
    base = torch.matmul(x.float(), w.float())
    ag = a[ids].float()                                     # (M, K, r)
    bg = b[ids].float()                                     # (M, r, N)
    if a_scale is not None:
        ag = ag * a_scale[ids].float()[:, None, None]
        bg = bg * b_scale[ids].float()[:, None, None]
    z = torch.einsum("mk,mkr->mr", x.float(), ag)
    if ranks is not None:
        rk = ranks.long()[ids]
        col = torch.arange(z.shape[-1], device=z.device)[None, :]
        z = torch.where(col < rk[:, None], z, torch.zeros_like(z))
    z = torch.einsum("mr,mrn->mn", z, bg)
    return (base + scale * z).to(x.dtype)


def batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, adapter_ids, fusion_w,
                                 scale: float):
    """Per-row Eq. 7 over a personalized bank and a shared global pair:
    ``y[i] = x[i]@w + scale·x[i]@[(w1ᵢA1[gᵢ]+w2ᵢA2)(w1ᵢB1[gᵢ]+w2ᵢB2)]``.

    a1: (C, K, r), b1: (C, r, N), a2: (K, r), b2: (r, N), adapter_ids: (M,),
    fusion_w: (M, 2) fp32 ``[w1, w2]`` per row.  The merged factors are
    built per row in fp32; one rounding to ``x.dtype`` at the end."""
    ids = adapter_ids.long()
    w1 = fusion_w[:, 0, None, None].float()
    w2 = fusion_w[:, 1, None, None].float()
    am = w1 * a1[ids].float() + w2 * a2[None].float()          # (M, K, r)
    bm = w1 * b1[ids].float() + w2 * b2[None].float()          # (M, r, N)
    base = torch.matmul(x.float(), w.float())
    z = torch.einsum("mk,mkr->mr", x.float(), am)
    z = torch.einsum("mr,mrn->mn", z, bm)
    return (base + scale * z).to(x.dtype)


def _gather_pool(pool, pool_scale, block_tables, rep: int):
    """The padded per-row block gather (B, MB*bs, Kv*rep, hd) in fp32,
    dequantizing int8 pools with their (NB, bs, Kv) scales."""
    B, MB = block_tables.shape
    bs, Kv, hd = pool.shape[1:]
    bt = block_tables.long()
    g = pool[bt].reshape(B, MB * bs, Kv, hd).float()
    if pool_scale is not None:
        g = g * pool_scale[bt].reshape(B, MB * bs, Kv)[..., None].float()
    return torch.repeat_interleave(g, rep, dim=2)


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        k_scale=None, v_scale=None,
                        scale: Optional[float] = None,
                        sliding_window: int = 0):
    """Paged decode attention.  q: (B, H, hd); pools (NB, bs, Kv, hd);
    block_tables (B, MB); lengths (B,) exclusive: row b attends
    ``[0, lengths[b])``, or with ``sliding_window`` W > 0 only
    ``[lengths[b] - W, lengths[b])``.  Empty rows give zeros."""
    B, H, hd = q.shape
    bs, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    k = _gather_pool(k_pool, k_scale, block_tables, H // Kv)
    v = _gather_pool(v_pool, v_scale, block_tables, H // Kv)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    k_pos = torch.arange(MB * bs, device=q.device)[None, :]
    mask = k_pos < lengths.long()[:, None]                  # (B, L)
    if sliding_window > 0:
        mask &= k_pos >= lengths.long()[:, None] - sliding_window
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[:, None, :], probs, torch.zeros_like(probs))
    return torch.einsum("bhk,bkhd->bhd", probs, v).to(q.dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                                k_scale=None, v_scale=None,
                                scale: Optional[float] = None,
                                sliding_window: int = 0):
    """Chunked paged prefill.  q: (B, T, H, hd) at positions
    ``lengths[b] + t``; pools already hold the chunk's K/V.  Query t of row
    b attends ``[0, lengths[b] + t]``, or with ``sliding_window`` W > 0
    only ``(lengths[b] + t - W, lengths[b] + t]``."""
    B, T, H, hd = q.shape
    bs, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    k = _gather_pool(k_pool, k_scale, block_tables, H // Kv)
    v = _gather_pool(v_pool, v_scale, block_tables, H // Kv)
    logits = torch.einsum("bthd,bkhd->bhtk", q.float(), k) * scale
    q_pos = (lengths.long()[:, None]
             + torch.arange(T, device=q.device)[None, :])   # (B, T)
    k_pos = torch.arange(MB * bs, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]        # (B, T, L)
    if sliding_window > 0:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[:, None], probs, torch.zeros_like(probs))
    return torch.einsum("bhtk,bkhd->bthd", probs, v).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0,
                        scale: Optional[float] = None):
    """q: (B, H, Sq, d), k/v: (B, Kv, Sk, d) with ``H % Kv == 0`` (kv heads
    repeated, as the reference's GQA wrapper does) -> (B, H, Sq, d).

    Positions are aligned at the end: query i sits at ``Sk - Sq + i``.
    Logits and softmax in fp32; the probabilities round to v's dtype before
    the value product, as in the reference."""
    H, Sq, d = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[2]
    rep = H // k.shape[1]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if sliding_window > 0:
        mask &= k_pos[None, :] > (q_pos[:, None] - sliding_window)
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)

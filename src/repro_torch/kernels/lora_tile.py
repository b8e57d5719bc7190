"""The tensor-core LoRA tile (``csrc/lora_mma.cuh``) seen from Python: which
tile a call takes, what the tensor-core tile needs, and its launch plan.

The four LoRA kernels (``batched_lora_matmul``, ``lora_matmul``,
``dual_lora_matmul``, ``batched_dual_lora_matmul``) have two tiles each,
picked by dtype (:func:`lora_tile`): bf16 activations with bf16 weights
run the tensor-core tile, anything else the fp32 CUDA-core tile of
``csrc/lora_common.cuh``.  :func:`check_mma_tile` raises for what the
tensor-core tile does not take.  :func:`plan` picks, from the shape
alone, the CTA tile of the base product and how many ranges of K the base
product and the shrink are split into; :func:`split_ranges` is the kernels'
own split of K tiles, and :func:`split_plan_ref` the whole call's
arithmetic in plain PyTorch, in the kernels' order wherever that order
decides a sum: partial products over each K range summed in split order,
then the LoRA term, then one rounding.  :func:`dual_split_plan_ref` is the
same for the two dual-LoRA kernels, in the order of their routes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

NUM_SMS = 132          # streaming multiprocessors of an H100 SXM
TARGET_CTAS = 2 * NUM_SMS
BK = 64                # K depth of one pipeline stage of the base product
MIN_K_TILES = 4        # K tiles a split of the base product keeps at least
SHRINK_ROWS = 64       # rows per shrink CTA
SHRINK_K = 64          # K per shrink chunk
SHRINK_CTAS = 8 * NUM_SMS
# (rows, columns) of the base product's CTA tile, by kind: mma.sync tiles
# for M <= 16 and M <= 64, the wgmma tile above
TILES = ((16, 64), (64, 128), (128, 256))


class Plan(NamedTuple):
    kind: int      # index into TILES
    split: int     # K ranges of the base product (1: the tile adds LoRA)
    zsplit: int    # K ranges of the shrink (1: it writes z itself)


def lora_tile(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """``"mma"`` (the tensor-core tile) for bf16 x with bf16 W, else
    ``"f32"`` (the CUDA-core tile, exact in fp32)."""
    bf = torch.bfloat16
    return "mma" if x_dtype == bf and w_dtype == bf else "f32"


def check_mma_tile(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError unless every bf16 row of x (M, K) and W (K, N)
    starts 16-byte aligned, as the tile's 16-byte copies need: K and N
    multiples of 8, and both data pointers 16-byte aligned."""
    K, N = w.shape
    if K % 8 or N % 8:
        raise ValueError(f"K = {K} and N = {N} must be multiples of 8: the "
                         "bf16 LoRA tile copies 16-byte aligned rows")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start 16-byte aligned, as the "
                             "bf16 LoRA tile's copies need")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, N: int, K: int) -> Plan:
    """The tensor-core tile's launch for an (M, K) x (K, N) call.

    The CTA tile follows M: 16 x 64 for M <= 16 (a decode step: rows
    padded to the mma's 16, narrow columns), 64 x 128 for M <= 64, else
    the 128 x 256 wgmma tile.  When a decode-sized output (M <= 64) has
    fewer tiles than the card has SMs, K is split so that about
    ``TARGET_CTAS`` CTAs stream W, each keeping at least ``MIN_K_TILES``
    K tiles; the wgmma tile never splits (its reduction would re-read each
    row's B).  The shrink splits K over its 64-row tiles towards
    ``SHRINK_CTAS`` CTAs: it has little work per CTA, so many in flight
    hide its loads."""
    kind = 0 if M <= 16 else 1 if M <= 64 else 2
    bm, bn = TILES[kind]
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    split = 1
    if kind < 2 and tiles < NUM_SMS:
        split = max(1, min(_cdiv(TARGET_CTAS, tiles),
                           _cdiv(K, BK) // MIN_K_TILES))
    zrows = _cdiv(M, SHRINK_ROWS)
    zsplit = max(1, min(_cdiv(K, SHRINK_K), _cdiv(SHRINK_CTAS, zrows)))
    return Plan(kind, split, zsplit)


def split_ranges(n: int, splits: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` ranges of ``n`` tiles that splits 0, 1, ... cover
    (``lora_mma.cuh::split_range``): contiguous, in order, sizes within 1."""
    return [(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def hi_lo(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``v`` as two bf16 terms (returned in fp32): hi = bf16(v), lo =
    bf16(v - hi), whose sum is within 2^-16 of ``v``; integer values up to
    127 are exact in hi (lo = 0)."""
    v = v.float()
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_plan_ref(x, w, a, b, adapter_ids: Optional[torch.Tensor],
                   scale: float, *, a_scale=None, b_scale=None, ranks=None,
                   p: Optional[Plan] = None) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The tensor-core tile's call in plain PyTorch, for x (M, K), w (K, N),
    a (C, K, r), b (C, r, N) (one client: ``adapter_ids`` None).  Returns
    (y (M, N) in x's dtype, z (M, r) fp32).

    Sums run in fp32 over the plan's K ranges and are added in split order:
    z = x·(hi + lo) of A (:func:`hi_lo`) from the shrink's ranges of
    ``SHRINK_K`` chunks, x·W from the base product's ranges of ``BK``
    tiles, then the LoRA term ``zs·B[g]`` with zs = scale·s[g]·z per row:
    as zs_hi·B_hi + zs_hi·B_lo + zs_lo·B_hi where the tile runs it on the
    tensor cores (no split of K), in fp32 where the split-K reduction
    does; then one rounding."""
    M, K = x.shape
    N = w.shape[1]
    C, _, r = a.shape
    p = p or plan(M, N, K)
    xf, wf = x.float(), w.float()
    ids = (torch.zeros(M, dtype=torch.long, device=x.device)
           if adapter_ids is None else adapter_ids.long())
    live = (ids >= 0) & (ids < C)
    g = torch.where(live, ids, torch.zeros_like(ids))
    ag = sum(hi_lo(a))[g]                                  # (M, K, r)
    bg = b[g].float()                                      # (M, r, N)
    z = torch.zeros((M, r), dtype=torch.float32, device=x.device)
    for lo, hi in split_ranges(_cdiv(K, SHRINK_K), p.zsplit):
        k0, k1 = lo * SHRINK_K, min(hi * SHRINK_K, K)
        z = z + torch.einsum("mk,mkr->mr", xf[:, k0:k1], ag[:, k0:k1])
    keep = live[:, None].expand(M, r)
    if ranks is not None:
        col = torch.arange(r, device=x.device)[None, :]
        keep = keep & (col < ranks.long()[g][:, None])
    z = torch.where(keep, z, torch.zeros_like(z))
    base = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for lo, hi in split_ranges(_cdiv(K, BK), p.split):
        k0, k1 = lo * BK, min(hi * BK, K)
        base = base + xf[:, k0:k1] @ wf[k0:k1]
    rs = torch.full((M,), float(scale), device=x.device)
    if a_scale is not None:
        rs = rs * a_scale.float()[g] * b_scale.float()[g]
    rs = torch.where(live, rs, torch.zeros_like(rs))
    zs = rs[:, None] * z
    if p.split == 1:
        (zh, zl), (bh, bl) = hi_lo(zs), hi_lo(bg)
        lora = sum(torch.einsum("mr,mrn->mn", u, v)
                   for u, v in ((zh, bh), (zh, bl), (zl, bh)))
    else:
        lora = torch.einsum("mr,mrn->mn", zs, bg)
    return (base + lora).to(x.dtype), z


def dual_split_plan_ref(x, w, a1, b1, a2, b2, adapter_ids, fusion_w,
                        scale: float, *, p: Optional[Plan] = None
                        ) -> torch.Tensor:
    """The tensor-core tile's dual-LoRA (Eq. 7) calls in plain PyTorch, in
    the order of each kernel's route; returns y (M, N) in x's dtype.

    ``fusion_w`` (2,) (``dual_lora_matmul``: a1, a2 (K, r), b1, b2 (r, N),
    ``adapter_ids`` None): the factors are merged first, in fp32 as the
    plain version merges them, and the call is :func:`split_plan_ref` of
    the merged pair.

    ``fusion_w`` (M, 2) (``batched_dual_lora_matmul``: a1 (C, K, r), b1
    (C, r, N), a2 (K, r), b2 (r, N), ids (M,)): by linearity, z1 = x·A1[g]
    and z2 = x·A2 from two shrinks (A as hi + lo, over the shrink's K
    ranges), z = w1·z1 + w2·z2 per row, and the LoRA term is
    (α·w1·z)·B1[g] + (α·w2·z)·B2, as hi/lo products where the tile runs it
    on the tensor cores (no split of K), in fp32 as z·(w1·B1[g] + w2·B2)
    where the split-K reduction does.  A row whose id lies outside [0, C)
    has w1 taken as 0: the global term only."""
    if fusion_w.dim() == 1:
        w1, w2 = fusion_w[0].float(), fusion_w[1].float()
        am = w1 * a1.float() + w2 * a2.float()
        bm = w1 * b1.float() + w2 * b2.float()
        return split_plan_ref(x, w, am[None], bm[None], None, scale, p=p)[0]
    M, K = x.shape
    N = w.shape[1]
    C, _, r = a1.shape
    p = p or plan(M, N, K)
    xf, wf = x.float(), w.float()
    ids = adapter_ids.long()
    live = (ids >= 0) & (ids < C)
    g = torch.where(live, ids, torch.zeros_like(ids))
    w1 = torch.where(live, fusion_w[:, 0].float(),
                     torch.zeros_like(fusion_w[:, 0].float()))
    w2 = fusion_w[:, 1].float()
    a1g, a2s = sum(hi_lo(a1))[g], sum(hi_lo(a2))
    z1 = torch.zeros((M, r), dtype=torch.float32, device=x.device)
    z2 = torch.zeros_like(z1)
    for lo, hi in split_ranges(_cdiv(K, SHRINK_K), p.zsplit):
        k0, k1 = lo * SHRINK_K, min(hi * SHRINK_K, K)
        z1 = z1 + torch.einsum("mk,mkr->mr", xf[:, k0:k1], a1g[:, k0:k1])
        z2 = z2 + xf[:, k0:k1] @ a2s[k0:k1]
    z1 = torch.where(live[:, None], z1, torch.zeros_like(z1))
    z = w1[:, None] * z1 + w2[:, None] * z2
    base = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for lo, hi in split_ranges(_cdiv(K, BK), p.split):
        k0, k1 = lo * BK, min(hi * BK, K)
        base = base + xf[:, k0:k1] @ wf[k0:k1]
    b1g = b1[g].float()                                    # (M, r, N)
    if p.split == 1:
        lora = 0
        for ws, bb in ((w1, b1g), (w2, b2.float()[None].expand(M, r, N))):
            (zh, zl), (bh, bl) = hi_lo((scale * ws)[:, None] * z), hi_lo(bb)
            lora = lora + sum(torch.einsum("mr,mrn->mn", u, v)
                              for u, v in ((zh, bh), (zh, bl), (zl, bh)))
    else:
        bm = w1[:, None, None] * b1g + w2[:, None, None] * b2.float()[None]
        lora = torch.einsum("mr,mrn->mn", scale * z, bm)
    return (base + lora).to(x.dtype)

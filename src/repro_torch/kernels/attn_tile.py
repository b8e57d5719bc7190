"""The tensor-core attention tile (``csrc/attn_mma.cuh``) seen from Python:
what it takes, and its arithmetic in plain PyTorch.

Both bf16 attention kernels run the tile: ``paged_prefill_attention`` and
``flash_attention``.  :func:`check_mma_tile` raises for what the tile does
not take.  :func:`paged_prefill_tile_ref` and :func:`flash_attention_tile_ref`
compute what the tile computes, in its order wherever that order decides a
rounding: keys in tiles of 64 from each CTA's first key, a running max per
row updated once per tile, P (or ``P·v_scale`` for int8 pools) rounded to
bf16 against that running max as the P·V operand, fp32 sums, one rounding
of the output.  The plain versions (``ref.py``) keep P in fp32 or round it
after normalising, so they can only hold the tile to one bf16 rounding of
max|v|; against these, a check holds every row to :func:`row_tol`, two
bf16 ulps of that row's largest output.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# head dims the tile is built for
MMA_HEAD_DIMS = (32, 64, 128, 256)
KEYS = 64         # keys per K/V tile
ROWS = 64         # query rows per CTA


def check_mma_tile(hd: int, tensors) -> None:
    """Raise ValueError for what the tensor-core tile does not take: a head
    dim outside ``MMA_HEAD_DIMS``, or a tensor of ``(name, tensor)`` pairs
    whose rows do not all start 16-byte aligned (its data pointer, or a
    stride of a leading axis in bytes), as its 16-byte copies need."""
    if hd not in MMA_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the bf16 attention tile takes head "
                         f"dims {MMA_HEAD_DIMS}")
    for name, t in tensors:
        el = t.element_size()
        if t.data_ptr() % 16 or any(s * el % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} (strides {t.stride()}) does not keep "
                             "every row 16-byte aligned, as the bf16 "
                             "attention tile's copies need")


def row_tol(out: torch.Tensor) -> torch.Tensor:
    """Per row (all axes but the last): two bf16 ulps of the row's largest
    |out|; 0 for a row of zeros."""
    top = out.float().abs().amax(dim=-1)
    _, e = torch.frexp(top)                 # top = m·2^e, 0.5 <= m < 1
    ulp = torch.ldexp(torch.ones_like(top), e - 8)
    return torch.where(top > 0, 2 * ulp, torch.zeros_like(top))


def _tile(q, k, v, lo, hi, sl2, k_begin, k_end, ks=None, vs=None):
    """One CTA's walk for a batch of CTAs with the same key tiles: q (N, R,
    d) fp32; k / v (N, L, d) fp32 holding bf16 (or int8) values, with
    per-key fp32 scales ``ks`` / ``vs`` (N, L) for int8; row r of CTA n
    attends keys lo <= j <= hi ((N, R) or broadcastable) in [k_begin,
    k_end).  Returns (N, R, d) fp32, before the output's rounding."""
    N, R, d = q.shape
    m = torch.full((N, R), -math.inf, device=q.device)
    den = torch.zeros((N, R), device=q.device)
    acc = torch.zeros((N, R, d), device=q.device)
    for k0 in range(k_begin, k_end, KEYS):
        j = torch.arange(k0, min(k0 + KEYS, k_end), device=q.device)
        s = torch.matmul(q, k[:, j].transpose(1, 2)) * sl2
        if ks is not None:
            s = s * ks[:, None, j]
        on = (j >= lo[..., None]) & (j <= hi[..., None])
        s = s.masked_fill(~on, -math.inf)
        mx = torch.maximum(m, s.amax(dim=-1))
        mu = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        den = den * alpha + p.sum(dim=-1)
        if vs is not None:
            p = p * vs[:, None, j]
        acc = (acc * alpha[..., None]
               + torch.matmul(p.to(torch.bfloat16).float(), v[:, j]))
        m = mx
    inv = torch.where(den > 0, 1.0 / den, torch.zeros_like(den))
    return acc * inv[..., None]


def paged_prefill_tile_ref(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None,
                           scale: Optional[float] = None,
                           sliding_window: int = 0):
    """``paged_prefill_attention`` as the tile computes it, CTA by CTA:
    the CTA of batch row b and folded rows f = t·G + g in [f0, f0 + 64)
    walks keys in tiles of 64 from its first query's window start,
    ``lengths[b] + f0 // G - W + 1`` (0 without a window W, and at least
    0), to its last query.  Pool slots the kernel never reads (at or past
    ``lengths[b] + T``, or past the table) are zeroed first."""
    B, T, H, hd = q.shape
    bs, Kv = k_pool.shape[1], k_pool.shape[2]
    G = H // Kv
    L = block_tables.shape[1] * bs
    scale = scale if scale is not None else hd ** -0.5
    bt = block_tables.long()
    lens = lengths.long()
    read = (torch.arange(L, device=q.device)[None, :]
            < (lens + T)[:, None])                            # (B, L)

    def gather(pool, rows):
        x = pool[bt].reshape((B, L, Kv) + rows).float()
        x = torch.where(read.view((B, L, 1) + (1,) * len(rows)), x,
                        torch.zeros_like(x))
        return x.transpose(1, 2).reshape((B * Kv, L) + rows)

    k, v = gather(k_pool, (hd,)), gather(v_pool, (hd,))
    ks = vs = None
    if k_scale is not None:
        ks, vs = gather(k_scale, ()), gather(v_scale, ())
    qf = (q.float().reshape(B, T, Kv, G, hd).permute(0, 2, 1, 3, 4)
          .reshape(B * Kv, T * G, hd))
    t = torch.arange(T * G, device=q.device) // G
    pos = lens[:, None] + t[None, :]                          # (B, T·G)
    hi = torch.clamp(pos, max=L - 1)
    lo = (torch.clamp(pos - sliding_window + 1, min=0) if sliding_window > 0
          else torch.zeros_like(pos))
    sl2 = scale * math.log2(math.e)
    o = torch.empty_like(qf)
    for b in range(B):
        cta = slice(b * Kv, (b + 1) * Kv)
        for f0 in range(0, T * G, ROWS):
            f = slice(f0, min(f0 + ROWS, T * G))
            k_end = min(int(pos[b, f.stop - 1]) + 1, L)
            o[cta, f] = _tile(qf[cta, f], k[cta], v[cta], lo[b, f], hi[b, f],
                              sl2, int(lo[b, f0]), k_end,
                              None if ks is None else ks[cta],
                              None if vs is None else vs[cta])
    o = o.reshape(B, Kv, T, G, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(B, T, H, hd).to(q.dtype)


def flash_attention_tile_ref(q, k, v, *, causal: bool = True,
                             sliding_window: int = 0,
                             scale: Optional[float] = None):
    """``flash_attention`` as the tile computes it: CTAs of 64 query rows,
    each walking keys from its first row's window start (0 without a
    window) to its last row's causal limit in tiles of 64.  q (B, H, Sq,
    d), k / v (B, Kv, Sk, d), positions aligned at the end."""
    B, H, Sq, d = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    off = Sk - Sq
    window = sliding_window
    scale = scale if scale is not None else d ** -0.5
    kf, vf = (t.float().repeat_interleave(G, dim=1).reshape(B * H, Sk, d)
              for t in (k, v))
    qf = q.float().reshape(B * H, Sq, d)
    out = torch.empty((B * H, Sq, d), device=q.device)
    for i0 in range(0, Sq, ROWS):
        i = torch.arange(i0, min(i0 + ROWS, Sq), device=q.device)
        qp = off + i
        p_first, p_last = off + i0, off + int(i[-1])
        kv_lo = max(0, p_first - window + 1) if window > 0 else 0
        kv_hi = min(Sk - 1, p_last) if causal else Sk - 1
        hi = torch.clamp(qp, max=kv_hi) if causal else torch.full_like(
            qp, kv_hi)
        lo = torch.clamp(qp - window + 1, min=0) if window > 0 else \
            torch.zeros_like(qp)
        out[:, i0:i0 + len(i)] = _tile(qf[:, i0:i0 + len(i)], kf, vf, lo, hi,
                                       scale * math.log2(math.e), kv_lo,
                                       kv_hi + 1)
    return out.reshape(B, H, Sq, d).to(q.dtype)


def tile_errors(out: torch.Tensor, tile_ref: torch.Tensor):
    """(max abs error, max over rows of error / :func:`row_tol`) of a
    kernel's output against its tile reference; the ratio is <= 1 when
    every row holds (inf where a row of zeros is missed)."""
    err = (out.float() - tile_ref.float()).abs().amax(dim=-1)
    tol = row_tol(tile_ref)
    ratio = torch.where(tol > 0, err / torch.where(tol > 0, tol,
                                                   torch.ones_like(tol)),
                        torch.where(err > 0, math.inf, 0.0))
    return float(err.max()), float(ratio.max())

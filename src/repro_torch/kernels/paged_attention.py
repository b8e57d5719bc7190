"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

Port of the Pallas kernel ``repro/kernels/paged_attention.py``: one query
token per serving row attends that row's K/V, read block by block from the
shared pool through its block table, never gathered into a padded tensor.
``lengths`` is exclusive (row b attends ``[0, lengths[b])``, or with a
sliding window W only ``[lengths[b] - W, lengths[b])``); empty rows give
zeros.  For tensors on the CPU the wrapper runs the plain version
(:func:`paged_attention_ref`); for CUDA tensors it launches the kernel or
raises; meta tensors take the meta route (``kernels/meta.py``).

The kernel is split-K flash decoding: each row's context is cut into
splits of :data:`SPLIT` positions, one CTA per (split, kv head, row); a
split that holds no position the row attends (past its end, or below its
window) exits.  A row of one live split is written by its CTA; longer
rows leave each live split's (m, l, acc) in a scratch buffer and a second
launch merges them in split order.  :func:`paged_attention_split_ref` is
that arithmetic in plain PyTorch.  Counters: ``paged_attention.launches``
counts calls that launch the kernel, ``.launches_combine`` those that also
launch the merge, and ``.launches_split`` the splits per (row, kv head)
launched.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import _gather_pool, paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_split_ref", "SPLIT", "HEAD_DIMS"]

# positions of a split (kSplit in csrc/paged_attention.cu)
SPLIT = 128
# head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 10 + [_F, _P]
        fn.restype = _I
    return fn


def check_pools(k_pool, v_pool, k_scale, v_scale, device) -> None:
    """Shape/type checks shared by both paged kernels' CUDA path."""
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must both be (NB, bs, Kv, hd); got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    quant = k_scale is not None
    want = torch.int8 if quant else torch.bfloat16
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != want or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on "
                             f"{device}; got {t.dtype} on {t.device}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t is None or t.dtype != torch.float32 or t.device != device
                    or t.shape != k_pool.shape[:3] or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"(NB, bs, Kv) tensor on {device}")


def check_tables(block_tables, lengths, B: int, device) -> None:
    for name, t, dim in (("block_tables", block_tables, 2),
                         ("lengths", lengths, 1)):
        if (t.dtype != torch.int32 or t.device != device or t.dim() != dim
                or t.shape[0] != B or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor with "
                             f"{B} rows on {device}")


def paged_attention_split_ref(q, k_pool, v_pool, block_tables, lengths, *,
                              k_scale=None, v_scale=None,
                              scale: Optional[float] = None,
                              split_len: int = SPLIT,
                              sliding_window: int = 0) -> torch.Tensor:
    """The kernel's split arithmetic in plain PyTorch, fp32 throughout.

    Row b attends ``[lo, n)``, ``n = min(lengths[b], MB * bs)``, ``lo = 0``
    or with a sliding window W ``max(0, n - W)``; its context is cut at
    multiples of ``split_len``.  Split s gives ``m_s`` (its largest score),
    ``l_s = sum exp(score - m_s)`` and ``acc_s = sum exp(score - m_s) v``
    over the positions of ``[lo, n)`` it holds.  A row of one live split
    (a split holding such a position) returns its ``acc_s / l_s``; a
    longer row merges its live splits in split order, ``sum acc_s c_s /
    sum l_s c_s`` with ``c_s = exp(m_s - max m)``; other splits contribute
    nothing and an empty row gives zeros.  Every sum runs over a dimension
    whose length is fixed by ``split_len`` and the head dim, so a row's
    output does not depend on the other rows.  Returns (B, H, hd) in q's
    dtype."""
    B, H, hd = q.shape
    bs, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    cap = MB * bs
    NS = max(1, -(-cap // split_len))
    pad = NS * split_len - cap
    k = _gather_pool(k_pool, k_scale, block_tables, H // Kv)   # (B, cap, H, hd)
    v = _gather_pool(v_pool, v_scale, block_tables, H // Kv)
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    # (B, NS, H, split_len, hd): every reduction below runs over the last dim
    k = k.reshape(B, NS, split_len, H, hd).transpose(2, 3)
    v = v.reshape(B, NS, split_len, H, hd).permute(0, 1, 3, 4, 2)
    n = lengths.long().clamp(0, cap)
    lo = (torch.clamp(n - sliding_window, min=0) if sliding_window > 0
          else torch.zeros_like(n))
    pos = torch.arange(NS * split_len, device=q.device).reshape(NS, split_len)
    valid = ((pos[None] < n[:, None, None])                   # (B, NS, 1, S)
             & (pos[None] >= lo[:, None, None]))[:, :, None, :]
    s = (q.float()[:, None, :, None, :] * k).sum(-1) * scale   # (B, NS, H, S)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(-1)                                             # (B, NS, H)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    v = torch.where(valid[:, :, :, None, :], v, torch.zeros_like(v))
    acc = (p[:, :, :, None, :] * v).sum(-1)                    # (B, NS, H, hd)
    s_lo = lo // split_len                                     # (B,)
    s_hi = (n + split_len - 1) // split_len                    # (B,)
    live = ((torch.arange(NS, device=q.device)[None] >= s_lo[:, None])
            & (torch.arange(NS, device=q.device)[None] < s_hi[:, None]))
    mx = torch.where(live[..., None], m,
                     torch.full_like(m, -1e30)).amax(1)        # (B, H)
    # one live split: c = exp(0) = 1 and the sums add to 0, so this is
    # acc_s / l_s exactly; no live split (an empty row): 0 / 1
    num = torch.zeros_like(acc[:, 0])
    den = torch.zeros_like(l[:, 0])
    for i in range(NS):
        c = torch.where(live[:, i, None], torch.exp(m[:, i] - mx),
                        torch.zeros_like(mx))
        num = num + acc[:, i] * c[..., None]
        den = den + l[:, i] * c
    out = num / torch.where(den > 0, den, torch.ones_like(den))[..., None]
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    sliding_window: int = 0) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (NB, bs, Kv, hd) bf16, or int8 with
    ``k_scale``/``v_scale`` (NB, bs, Kv) fp32; block_tables: (B, MB) int32;
    lengths: (B,) int32 exclusive; ``sliding_window`` W > 0 limits row b to
    its last W positions.  Returns (B, H, hd) in q's dtype.  The kernel
    takes head dims :data:`HEAD_DIMS` and 16-byte aligned pools."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd); got {tuple(q.shape)}")
    B, H, hd = q.shape
    Kv = k_pool.shape[2]
    if H % Kv or k_pool.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    scale = float(scale if scale is not None else hd ** -0.5)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   k_scale=k_scale, v_scale=v_scale,
                                   scale=scale, sliding_window=sliding_window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no paged_attention kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError("q must be contiguous float32 or bfloat16")
    check_pools(k_pool, v_pool, k_scale, v_scale, q.device)
    check_tables(block_tables, lengths, B, q.device)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the decode kernel takes head dims "
                         f"{HEAD_DIMS}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("k_pool and v_pool must be 16-byte aligned")
    bs, MB = k_pool.shape[1], block_tables.shape[1]
    if q.device.type == "meta":
        meta.record("paged_attention", meta.paged_attention_cost(
            B, H, Kv, hd, bs, MB, sliding_window, q.dtype,
            k_scale is not None, SPLIT))
        return meta.empty(q.shape, q.dtype)
    NS = max(1, -(-(MB * bs) // SPLIT))
    out = torch.empty_like(q)
    # (m, l, acc) of every split, only when a row can need more than one
    part = (torch.empty(B * H * NS * (hd + 2), dtype=torch.float32,
                        device=q.device) if NS > 1 else None)
    quant = k_scale is not None
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 B, H, Kv, hd, bs, MB, SPLIT, int(sliding_window),
                 int(q.dtype == torch.bfloat16), int(quant), scale,
                 build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.launches_split += NS
    paged_attention.launches_combine += int(NS > 1)
    return out


paged_attention.launches = 0
paged_attention.launches_split = 0
paged_attention.launches_combine = 0

"""Chunked paged prefill: the K/V scatter and the wrapper of
``csrc/paged_prefill.cu``.

Port of ``repro/kernels/paged_prefill.py``.  :func:`paged_scatter` /
:func:`paged_scatter_quant` write a chunk's new K/V through the block
tables (plain tensor indexing; scratch block 0 takes ragged tails and
inactive rows).  Unlike the functional reference they update the pools IN
PLACE — a serving pool is gigabytes — and return them.

:func:`paged_prefill_attention` attends T chunk queries per row against
pools that already hold the chunk: query t of row b attends
``[0, lengths[b] + t]``, or with a sliding window W only ``(lengths[b] +
t - W, lengths[b] + t]``.  CPU tensors run the plain version; CUDA
tensors launch the kernel or raise.  The kernel has two tiles, picked by
q's dtype: bf16 queries run the tensor-core tile (``csrc/attn_mma.cuh``,
head dims 32, 64, 128 and 256), fp32 queries the fp32 CUDA-core tile.
``paged_prefill_attention.launches`` counts kernel launches, and
``launches_mma`` / ``launches_f32`` split them by tile.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attn_tile import check_mma_tile
from repro_torch.kernels.paged_attention import check_pools, check_tables
from repro_torch.kernels.quant import quantize_int8
from repro_torch.kernels.ref import paged_prefill_attention_ref

__all__ = ["paged_scatter", "paged_scatter_quant", "paged_prefill_attention",
           "paged_prefill_attention_ref"]

# folded query rows per CTA of the fp32 tile (fewer when head_dim is wide)
TILE_ROWS = 16
# per-thread accumulators of the fp32 tile (csrc/paged_common.cuh)
THREADS, MAX_ACC = 128, 32
MAX_SMEM = 227 * 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _scatter_coords(B: int, S: int, bs_blk: int, block_tables, lengths,
                    n_new):
    """(block ids, in-block offsets) for token t of row b: position
    ``lengths[b] + t`` through the row's table; with ``n_new``, tokens
    ``t >= n_new[b]`` go to scratch block 0."""
    dev = block_tables.device
    rows_t = torch.arange(S, device=dev)
    pos = lengths.long()[:, None] + rows_t[None, :]            # (B, S)
    # tail tokens may sit past the table's width; clamp the lookup (they are
    # redirected to block 0 below), as the reference's gather clamps
    col = torch.clamp(pos // bs_blk, max=block_tables.shape[1] - 1)
    blk = torch.gather(block_tables.long(), 1, col)
    if n_new is not None:
        blk = torch.where(rows_t[None, :] < n_new.long()[:, None], blk,
                          torch.zeros_like(blk))
    return blk, pos % bs_blk


def _last_writer(blk, off, pool):
    """For each of the B·S writes at (``blk``, ``off``), the flat index of
    the last write in (row, position) order that lands on the same pool
    position: the one that wins in the reference's serial scatter.  Only
    scratch block 0 takes several writes (ragged tails, idle rows), and
    parallel index writes would leave any of them there; what block 0
    holds is read by tail positions' queries, whose hidden states an MoE
    layer routes and counts against capacity, so it must not vary from
    run to run.  ``amax`` is order-free, so the result is deterministic
    on a card too, with no host round trip."""
    NB, bs = pool.shape[0], pool.shape[1]
    dest = (blk.long() * bs + off.long()).reshape(-1)
    idx = torch.arange(dest.numel(), device=dest.device)
    last = torch.full((NB * bs,), -1, dtype=torch.long, device=dest.device)
    last.scatter_reduce_(0, dest, idx, reduce="amax")
    return last[dest]


def _winning(x, src):
    """(B, S, ...) values with each write replaced by its last writer's."""
    B, S = x.shape[0], x.shape[1]
    return x.reshape(B * S, *x.shape[2:])[src].reshape(x.shape)


def paged_scatter(k_pool, v_pool, k, v, block_tables, lengths, n_new=None):
    """Write k/v (B, S, Kv, hd) into the pools at ``lengths[b] + t``; with
    ``n_new``, ragged tails land in scratch block 0, the last one in
    (row, position) order winning each of its positions.  In place;
    returns (k_pool, v_pool)."""
    B, S = k.shape[0], k.shape[1]
    blk, off = _scatter_coords(B, S, k_pool.shape[1], block_tables, lengths,
                               n_new)
    src = _last_writer(blk, off, k_pool)
    k_pool[blk, off] = _winning(k, src).to(k_pool.dtype)
    v_pool[blk, off] = _winning(v, src).to(v_pool.dtype)
    return k_pool, v_pool


def paged_scatter_quant(k_pool, v_pool, k_scale, v_scale, k, v,
                        block_tables, lengths, n_new=None):
    """:func:`paged_scatter` for int8 pools: each token's K/V quantizes per
    (token, kv-head) and its fp32 scale lands at the same coordinates.
    In place; returns the four pools."""
    B, S = k.shape[0], k.shape[1]
    blk, off = _scatter_coords(B, S, k_pool.shape[1], block_tables, lengths,
                               n_new)
    src = _last_writer(blk, off, k_pool)
    qk, sk = quantize_int8(k, dim=-1)
    qv, sv = quantize_int8(v, dim=-1)
    k_pool[blk, off] = _winning(qk, src)
    v_pool[blk, off] = _winning(qv, src)
    k_scale[blk, off] = _winning(sk, src)
    v_scale[blk, off] = _winning(sv, src)
    return k_pool, v_pool, k_scale, v_scale


def smem_bytes(rows: int, bs: int, hd: int) -> int:
    """Shared memory of one fp32 tile (``tile_smem_floats``)."""
    return 4 * (rows * hd + bs * (hd + 1) + bs * hd + rows * bs + 3 * rows)


def tile_rows(T: int, G: int, hd: int) -> int:
    return max(1, min(T * G, TILE_ROWS, (THREADS * MAX_ACC) // hd))


def _lib():
    lib = build.load("paged_prefill")
    fn = lib.paged_prefill_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 11 + [_F, _P]
        fn.restype = _I
    return fn


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, *,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            sliding_window: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd) at positions ``lengths[b] + t``; pools (NB, bs, Kv,
    hd) bf16 (or int8 with (NB, bs, Kv) fp32 scales) already holding the
    chunk; block_tables (B, MB) int32; lengths (B,) int32 context before the
    chunk; ``sliding_window`` W > 0 limits query t to the W positions
    ending at its own.  Returns (B, T, H, hd) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd); got {tuple(q.shape)}")
    B, T, H, hd = q.shape
    Kv = k_pool.shape[2]
    if H % Kv or k_pool.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    scale = float(scale if scale is not None else hd ** -0.5)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pool, v_pool, block_tables,
                                           lengths, k_scale=k_scale,
                                           v_scale=v_scale, scale=scale,
                                           sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_prefill_attention kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError("q must be contiguous float32 or bfloat16")
    check_pools(k_pool, v_pool, k_scale, v_scale, q.device)
    check_tables(block_tables, lengths, B, q.device)
    bs = k_pool.shape[1]
    quant = k_scale is not None
    mma = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    rows = tile_rows(T, H // Kv, hd)
    if mma:
        check_mma_tile(hd, (("q", q), ("k_pool", k_pool),
                            ("v_pool", v_pool), ("out", out)))
    elif hd > THREADS * MAX_ACC or smem_bytes(rows, bs, hd) > MAX_SMEM:
        raise ValueError(f"head_dim {hd} (block {bs}) exceeds the kernel's "
                         "tile")
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, T, H, Kv, hd, bs, block_tables.shape[1], rows,
                 int(sliding_window), int(mma), int(quant), scale,
                 build.stream_ptr(q.device))
    build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    if mma:
        paged_prefill_attention.launches_mma += 1
    else:
        paged_prefill_attention.launches_f32 += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.launches_mma = 0
paged_prefill_attention.launches_f32 = 0

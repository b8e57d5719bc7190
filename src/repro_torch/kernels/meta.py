"""The kernels' meta route: what a launch would cost, without a launch.

Given tensors on ``torch.device("meta")``, each kernel wrapper returns
empty meta tensors of exactly the shapes and dtypes its CUDA launch
returns, and records the launch here: its FLOPs, the bytes it reads and
writes (each input read once, each output written once, as
``chip_smoke.py`` reckons a kernel's bound) and its scratch bytes (the
LoRA tile's partials and operand rows, the split-K partials of decode),
which live only for the launch.  A meta tensor never reaches a launch or
a kernel's plain version; a CUDA tensor still launches or raises.

Where the work depends on the data, the meta route counts the most a
call of these shapes can need, since a meta tensor holds no data: a
batched LoRA call reads ``min(C, M)`` clients' pairs, decode attends
every row's whole table (or its window), a prefill chunk sits at the end
of its row's table.

:func:`recording` hands every record to a sink for the duration of a
block (``launch/dryrun.py``'s tally).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple

import numpy as np
import torch

__all__ = ["Cost", "record", "recording", "lora_cost", "batched_lora_cost",
           "dual_lora_cost", "batched_dual_lora_cost", "flash_cost",
           "paged_attention_cost", "paged_prefill_cost", "scatter_cost",
           "empty"]

_sinks: List[Callable] = []


class Cost(NamedTuple):
    flops: float
    bytes_read: float
    bytes_written: float
    scratch_bytes: float = 0.0


def record(name: str, cost: Cost) -> None:
    """One meta launch of kernel ``name``: passed to every active sink."""
    for sink in list(_sinks):
        sink(name, cost)


@contextlib.contextmanager
def recording(sink: Callable):
    """``sink(name, cost)`` receives every meta launch inside the block."""
    _sinks.append(sink)
    try:
        yield sink
    finally:
        _sinks.remove(sink)


def empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tile_scratch_bytes(M, N, K, C, r, x_dtype, w_dtype, z_given, *,
                        pairs=1, extra=()) -> float:
    from repro_torch.kernels import lora_tile
    from repro_torch.kernels.batched_lora import tile_scratch_sizes
    tile = lora_tile.lora_tile(x_dtype, w_dtype)
    if M == 0:
        return 0.0
    return 4.0 * sum(tile_scratch_sizes(lora_tile.plan(M, N, K), tile, M, N,
                                        C, r, z_given, pairs=pairs,
                                        extra=extra))


def lora_cost(M, K, N, r, x_dtype, w_dtype) -> Cost:
    """``lora_matmul``: x, W, A and B (fp32) in; y and z = x·A (fp32, kept
    for the backward) out."""
    x_el, w_el = x_dtype.itemsize, w_dtype.itemsize
    return Cost(2.0 * M * K * N + 2.0 * M * r * (K + N),
                x_el * M * K + w_el * K * N + 4.0 * r * (K + N),
                x_el * M * N + 4.0 * M * r,
                _tile_scratch_bytes(M, N, K, 1, r, x_dtype, w_dtype, True))


def batched_lora_cost(M, K, N, C, r, x_dtype, w_dtype, bank_el) -> Cost:
    """``batched_lora_matmul``: x, W, the row ids and ``min(C, M)``
    clients' pairs in; y out; z and the tile's parts as scratch."""
    x_el, w_el = x_dtype.itemsize, w_dtype.itemsize
    active = min(C, M)
    return Cost(2.0 * M * K * N + 2.0 * M * r * (K + N),
                x_el * M * K + w_el * K * N + 4.0 * M
                + active * bank_el * r * (K + N),
                x_el * M * N,
                _tile_scratch_bytes(M, N, K, C, r, x_dtype, w_dtype, False))


def dual_lora_cost(M, K, N, r, x_dtype, w_dtype) -> Cost:
    """``dual_lora_matmul``: x, W, both fp32 pairs and the two weights in;
    y out; z, the merged pair and the tile's parts as scratch."""
    x_el, w_el = x_dtype.itemsize, w_dtype.itemsize
    return Cost(2.0 * M * K * N + 2.0 * M * r * (K + N) + 3.0 * r * (K + N),
                x_el * M * K + w_el * K * N + 8.0 * r * (K + N) + 8.0,
                x_el * M * N,
                _tile_scratch_bytes(M, N, K, 1, r, x_dtype, w_dtype, False,
                                    extra=(K * r, r * N)))


def batched_dual_lora_cost(M, K, N, C, r, x_dtype, w_dtype) -> Cost:
    """``batched_dual_lora_matmul``: x, W, ``min(C, M)`` personalized
    pairs and the global pair, ids and per-row weights in; y out."""
    x_el, w_el = x_dtype.itemsize, w_dtype.itemsize
    active = min(C, M)
    return Cost(2.0 * M * K * N + 4.0 * M * r * (K + N),
                x_el * M * K + w_el * K * N + 4.0 * (active + 1) * r * (K + N)
                + 12.0 * M,
                x_el * M * N,
                _tile_scratch_bytes(M, N, K, C + 1, r, x_dtype, w_dtype,
                                    False, pairs=2, extra=(M,)))


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a flash call attends: query i sits at ``Sk - Sq
    + i`` and sees keys up to its own (causal) and past ``p - window``."""
    p = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(p, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = (np.maximum(p - window + 1, 0) if window > 0
          else np.zeros(Sq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(B, H, Kv, Sq, Sk, d, causal, window, dtype) -> Cost:
    """``flash_attention``: q, k, v in, o out; 4·d FLOPs per attended
    pair and head."""
    el = dtype.itemsize
    pairs = attended_pairs(Sq, Sk, causal, window)
    return Cost(4.0 * d * pairs * B * H,
                el * (B * H * Sq * d + 2 * B * Kv * Sk * d),
                el * B * H * Sq * d)


def _kv_bytes(ctx, Kv, hd, int8) -> float:
    return (1 if int8 else 2) * 2.0 * ctx * Kv * hd + (8.0 * ctx * Kv
                                                        if int8 else 0.0)


def paged_attention_cost(B, H, Kv, hd, bs, MB, window, q_dtype, int8,
                         split) -> Cost:
    """``paged_attention`` with every row's table full: each row attends
    ``min(MB·bs, window)`` positions; the (m, l, acc) partials of every
    split are scratch when a table spans more than one split."""
    q_el = q_dtype.itemsize
    cap = MB * bs
    ctx = B * (min(cap, window) if window > 0 else cap)
    NS = max(1, -(-cap // split))
    return Cost(4.0 * hd * H * ctx,
                _kv_bytes(ctx, Kv, hd, int8) + q_el * B * H * hd
                + 4.0 * B * (MB + 1),
                q_el * B * H * hd,
                4.0 * B * H * NS * (hd + 2) if NS > 1 else 0.0)


def paged_prefill_cost(B, T, H, Kv, hd, bs, MB, window, q_dtype,
                       int8) -> Cost:
    """``paged_prefill_attention`` with each row's chunk at the end of its
    table (context ``n = MB·bs - T`` before it): a row reads its keys from
    the first query's window start and attends ``min(n + t + 1, window)``
    keys at query t."""
    q_el = q_dtype.itemsize
    n = max(0, MB * bs - T)
    W = window if window > 0 else 1 << 62
    ctx = n + T - max(0, n - W + 1)
    t = np.arange(T, dtype=np.int64)
    pairs = int(np.minimum(n + t + 1, W).sum())
    return Cost(4.0 * hd * H * B * pairs,
                _kv_bytes(B * ctx, Kv, hd, int8) + q_el * B * T * H * hd
                + 4.0 * B * (MB + 1),
                q_el * B * T * H * hd)


def scatter_cost(k: torch.Tensor, v: torch.Tensor, pool_dtype,
                 int8: bool) -> Cost:
    """The paged scatter: the chunk's K/V in, as many pool positions (and
    their fp32 scales on int8 pools) out."""
    B, S, Kv, hd = k.shape
    n = B * S * Kv
    return Cost(0.0, 2.0 * k.element_size() * n * hd,
                2.0 * pool_dtype.itemsize * n * hd
                + (8.0 * n if int8 else 0.0))

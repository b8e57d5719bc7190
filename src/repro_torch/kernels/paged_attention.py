"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

Port of the Pallas kernel ``repro/kernels/paged_attention.py``: one query
token per serving row attends that row's K/V, read block by block from the
shared pool through its block table, never gathered into a padded tensor.
``lengths`` is exclusive (row b attends ``[0, lengths[b])``); empty rows
give zeros.  For tensors on the CPU the wrapper runs the plain version
(:func:`paged_attention_ref`); for CUDA tensors it launches the kernel or
raises.  ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref", "smem_bytes"]

# per-thread accumulators of the tile routine (csrc/paged_common.cuh)
THREADS, MAX_ACC = 128, 32
MAX_SMEM = 227 * 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def smem_bytes(rows: int, bs: int, hd: int) -> int:
    """Shared memory of one attention tile (``tile_smem_floats``)."""
    return 4 * (rows * hd + bs * (hd + 1) + bs * hd + rows * bs + 3 * rows)


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_F, _P]
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


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (NB, bs, Kv, hd) bf16, or int8 with
    ``k_scale``/``v_scale`` (NB, bs, Kv) fp32; block_tables: (B, MB) int32;
    lengths: (B,) int32 exclusive.  Returns (B, H, hd) in q's dtype."""
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
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError("q must be contiguous float32 or bfloat16")
    check_pools(k_pool, v_pool, k_scale, v_scale, q.device)
    check_tables(block_tables, lengths, B, q.device)
    NB, bs = k_pool.shape[:2]
    G = H // Kv
    if G * hd > THREADS * MAX_ACC or smem_bytes(G, bs, hd) > MAX_SMEM:
        raise ValueError(f"group {G} x head_dim {hd} (block {bs}) exceeds "
                         "the kernel's tile")
    out = torch.empty_like(q)
    quant = k_scale is not None
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, H, Kv, hd, bs, block_tables.shape[1],
                 int(q.dtype == torch.bfloat16), int(quant), scale,
                 build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

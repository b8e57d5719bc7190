"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``: online-softmax attention of q (B, H, Sq, d) against
k/v (B, Kv, Sk, d), causal with positions aligned at the end (query i sits
at ``Sk - Sq + i``), with an optional sliding window.  Where the reference
repeats K/V heads for GQA before the call, the kernel reads kv head
``h // (H // Kv)`` itself; the plain version repeats, as the reference
does.  Any Sq and Sk work (the reference asks for multiples of its tile);
a causal call needs ``Sq <= Sk``, so that every query has a key.

It carries every attention of a training forward, so it is
differentiable: :class:`FlashAttention` runs the kernel forward and a
plain PyTorch backward that recomputes the probabilities in fp32 from the
saved q, k, v (the reference has no backward kernel either).

CPU tensors run the plain version (:func:`flash_attention_ref`); CUDA
tensors launch the kernel or raise; meta tensors take the meta route
(``kernels/meta.py``), their backward the plain one on meta tensors.  The kernel has two tiles, picked by
dtype: bf16 runs the tensor-core tile (``csrc/attn_mma.cuh``, head dims
32, 64 and 128, every row start 16-byte aligned), fp32 the fp32 CUDA-core
tile.  ``flash_attention.launches`` counts launches, and
``launches_mma`` / ``launches_f32`` split them by tile.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.attn_tile import check_mma_tile
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "FlashAttention"]

# the fp32 tile
THREADS = 128
MAX_ACC = 32          # accumulators per thread: rows * d <= THREADS * MAX_ACC
TILE_ROWS = 32        # query rows per CTA (fewer when d is wide)
KV_TILE = 32
MAX_SMEM = 227 * 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def tile_rows(d: int) -> int:
    return max(1, min(TILE_ROWS, (THREADS * MAX_ACC) // d))


def smem_bytes(rows: int, d: int) -> int:
    return 4 * (rows * d + KV_TILE * (d + 1) + KV_TILE * d + rows * KV_TILE
                + 3 * rows)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 10 + [_F, _P]
        fn.restype = _I
    return fn


def _launch(q, k, v, causal: bool, sliding_window: int, scale: float):
    """One launch on the card.  Inputs may be strided views with a
    contiguous last axis; the output is laid out (B, Sq, H, d) in memory
    and returned as its (B, H, Sq, d) view, which is what the model's
    layout wants without a copy."""
    B, H, Sq, d = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be float32 or bfloat16 like q; got "
                             f"{t.dtype}")
        if t.device != dev or t.stride(-1) != 1:
            raise ValueError(f"{name} must lie on {dev} with a contiguous "
                             f"last axis")
    mma = q.dtype == torch.bfloat16
    rows = tile_rows(d)
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=dev)
    o = out.transpose(1, 2)
    if mma:
        check_mma_tile(d, (("q", q), ("k", k), ("v", v), ("out", out)))
    elif d > THREADS * MAX_ACC or smem_bytes(rows, d) > MAX_SMEM:
        raise ValueError(f"head_dim {d} exceeds the kernel's tile")
    if dev.type == "meta":
        meta.record("flash_attention", meta.flash_cost(
            B, H, Kv, Sq, Sk, d, causal, sliding_window, q.dtype))
        return o
    if out.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), B, H, Kv, Sq, Sk, d,
                 rows, int(causal), int(sliding_window), int(mma),
                 float(scale), build.stream_ptr(dev))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    if mma:
        flash_attention.launches_mma += 1
    else:
        flash_attention.launches_f32 += 1
    return o


class FlashAttention(torch.autograd.Function):
    """The kernel forward; a plain backward that recomputes the fp32
    probabilities from the saved q, k, v and differentiates the plain
    version (so its gradients are those of the plain path)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, sliding_window, scale)
        return _launch(q, k, v, causal, sliding_window, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, scale = ctx.args
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = flash_attention_ref(qd, kd, vd, causal=causal,
                                      sliding_window=window, scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), do)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, d), k/v: (B, Kv, Sk, d) with ``H % Kv == 0`` ->
    (B, H, Sq, d) in q's dtype; differentiable in q, k and v."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q (B, H, Sq, d), k/v (B, Kv, Sk, d)")
    B, H, Sq, d = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, Kv, Sk, d) or tuple(v.shape) != tuple(k.shape)
            or Kv == 0 or H % Kv):
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq {Sq} > Sk {Sk}: the "
                         "first queries would have no key")
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash_attention kernel for {q.device}")
    return FlashAttention.apply(q, k, v, bool(causal), int(sliding_window),
                                scale)


flash_attention.launches = 0
flash_attention.launches_mma = 0
flash_attention.launches_f32 = 0

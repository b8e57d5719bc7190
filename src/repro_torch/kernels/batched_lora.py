"""Batched multi-tenant LoRA matmul: the wrapper of ``csrc/batched_lora.cu``.

Port of the Pallas kernel ``repro/kernels/batched_lora.py::
batched_lora_matmul``: ``y[i] = x[i]·W + α·x[i]·A[g[i]]·B[g[i]]`` with
per-row client ids over stacked banks, an optional per-client rank mask
(ragged banks) and optional int8 banks with per-client scales.  The
kernel computes the base product itself (fp32 accumulation) and rounds
once in its epilogue.  CPU tensors run the plain version
(:func:`batched_lora_matmul_ref`); CUDA tensors launch the kernel or
raise.  ``batched_lora_matmul.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import batched_lora_matmul_ref

__all__ = ["batched_lora_matmul", "batched_lora_matmul_ref"]

MAX_RANK = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("batched_lora")
    fn = lib.batched_lora_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 8 + [_F, _P]
        fn.restype = _I
    return fn


def _check(name, t, dtypes, shape, device):
    if (t.dtype not in dtypes or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {'/'.join(map(str, dtypes))} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def batched_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, adapter_ids: torch.Tensor,
                        scale: float = 1.0, *,
                        a_scale: Optional[torch.Tensor] = None,
                        b_scale: Optional[torch.Tensor] = None,
                        ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K), w: (K, N), a: (C, K, r), b: (C, r, N), adapter_ids: (M,)
    int32 -> (M, N) in x's dtype.  int8 banks pass ``a_scale``/``b_scale``
    (C,) fp32; ragged banks pass ``ranks`` (C,) int32."""
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("x (M, K), w (K, N), a (C, K, r), b (C, r, N)")
    M, K = x.shape
    N = w.shape[1]
    C, _, r = a.shape
    if (w.shape[0] != K or tuple(a.shape) != (C, K, r)
            or tuple(b.shape) != (C, r, N)):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if (a_scale is None) != (b_scale is None):
        raise ValueError("int8 banks need both a_scale and b_scale")
    if x.device.type == "cpu":
        return batched_lora_matmul_ref(x, w, a, b, adapter_ids, scale,
                                       a_scale=a_scale, b_scale=b_scale,
                                       ranks=ranks)
    if x.device.type != "cuda":
        raise ValueError(f"no batched_lora_matmul kernel for {x.device}")
    dev = x.device
    quant = a_scale is not None
    fl = (torch.float32, torch.bfloat16)
    bank = (torch.int8,) if quant else (torch.float32,)
    _check("x", x, fl, (M, K), dev)
    _check("w", w, fl, (K, N), dev)
    _check("a", a, bank, (C, K, r), dev)
    _check("b", b, bank, (C, r, N), dev)
    _check("adapter_ids", adapter_ids, (torch.int32,), (M,), dev)
    if quant:
        _check("a_scale", a_scale, (torch.float32,), (C,), dev)
        _check("b_scale", b_scale, (torch.float32,), (C,), dev)
    if ranks is not None:
        _check("ranks", ranks, (torch.int32,), (C,), dev)
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y
    z = torch.empty((M, r), dtype=torch.float32, device=dev)
    err = _lib()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 a_scale.data_ptr() if quant else None,
                 b_scale.data_ptr() if quant else None,
                 ranks.data_ptr() if ranks is not None else None,
                 adapter_ids.data_ptr(), z.data_ptr(), y.data_ptr(),
                 M, K, N, C, r, int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), int(quant), float(scale),
                 build.stream_ptr(dev))
    build.check(err, "batched_lora_matmul")
    batched_lora_matmul.launches += 1
    return y


batched_lora_matmul.launches = 0

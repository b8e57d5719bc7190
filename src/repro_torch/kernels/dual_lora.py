"""Fused dual-LoRA (Eq. 7) matmul: the wrapper of ``csrc/dual_lora.cu``.

Port of the Pallas kernel ``repro/kernels/dual_lora.py::dual_lora_matmul``:
``y = x·W + α·x·(w1·A1 + w2·A2)·(w1·B1 + w2·B2)`` with two fp32 fusion
weights, fp32 accumulation and one rounding to x's dtype.  The merged
factors are never written to memory.  It carries every projection of a
stage-3 AdaFusion evaluation, which takes no gradient: the kernel is
forward only and the wrapper raises if a gradient is asked of it.

CPU tensors run the plain version (:func:`dual_lora_matmul_ref`); CUDA
tensors launch the kernel or raise; meta tensors take the meta route
(``kernels/meta.py``).  The kernel has two tiles, picked by
dtype as the LoRA kernels' are (``kernels/lora_tile.py``): bf16 x with bf16
W merges the two pairs in fp32 on the card and runs ``lora_matmul``'s
tensor-core tile on the merged pair (``csrc/lora_mma.cuh``: K and N
multiples of 8, 16-byte aligned x and W); anything else the fp32
CUDA-core tile.  ``dual_lora_matmul.launches`` counts launches, and
``launches_mma`` / ``launches_f32`` split them by tile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, lora_tile, meta
from repro_torch.kernels.batched_lora import MAX_RANK, _check, tile_scratch
from repro_torch.kernels.ref import dual_lora_matmul_ref

__all__ = ["dual_lora_matmul", "dual_lora_matmul_ref"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("dual_lora")
    fn = lib.dual_lora_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 9 + [_F, _P]
        fn.restype = _I
    return fn


def dual_lora_matmul(x: torch.Tensor, w: torch.Tensor, a1: torch.Tensor,
                     b1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
                     fusion_w: torch.Tensor, scale: float = 1.0
                     ) -> torch.Tensor:
    """x: (M, K), w: (K, N), a1/a2: (K, r) fp32, b1/b2: (r, N) fp32,
    fusion_w: (2,) fp32 = [w1 (personalized), w2 (global)] -> (M, N) in
    x's dtype."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("x (M, K), w (K, N)")
    M, K = x.shape
    N, r = w.shape[1], a1.shape[-1]
    if (w.shape[0] != K or tuple(a1.shape) != (K, r)
            or tuple(a2.shape) != (K, r) or tuple(b1.shape) != (r, N)
            or tuple(b2.shape) != (r, N) or tuple(fusion_w.shape) != (2,)):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a1 {tuple(a1.shape)}, b1 "
                         f"{tuple(b1.shape)}, a2 {tuple(a2.shape)}, b2 "
                         f"{tuple(b2.shape)}, fusion_w "
                         f"{tuple(fusion_w.shape)}")
    if x.device.type == "cpu":
        return dual_lora_matmul_ref(x, w, a1, b1, a2, b2, fusion_w[0],
                                    fusion_w[1], scale)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no dual_lora_matmul kernel for {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a1, b1, a2, b2, fusion_w)):
        raise RuntimeError("dual_lora_matmul is forward only (the AdaFusion "
                           "search takes no gradient); call it under "
                           "torch.no_grad()")
    dev = x.device
    fl = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    _check("x", x, fl, (M, K), dev)
    _check("w", w, fl, (K, N), dev)
    for name, t, shape in (("a1", a1, (K, r)), ("b1", b1, (r, N)),
                           ("a2", a2, (K, r)), ("b2", b2, (r, N)),
                           ("fusion_w", fusion_w, (2,))):
        _check(name, t, f32, shape, dev)
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    tile = lora_tile.lora_tile(x.dtype, w.dtype)
    if tile == "mma":
        lora_tile.check_mma_tile(x, w)
    if dev.type == "meta":
        meta.record("dual_lora_matmul", meta.dual_lora_cost(
            M, K, N, r, x.dtype, w.dtype))
        return meta.empty((M, N), x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y
    p = lora_tile.plan(M, N, K)
    # the extra parts: the merged pair, w1·A1 + w2·A2 and w1·B1 + w2·B2
    z, zpart, ypart, zl, bl, am, bm = tile_scratch(
        p, tile, M, N, 1, r, dev, extra=(K * r, r * N))
    err = _lib()(x.data_ptr(), w.data_ptr(), a1.data_ptr(), b1.data_ptr(),
                 a2.data_ptr(), b2.data_ptr(), fusion_w.data_ptr(),
                 z.data_ptr(), zpart, ypart, zl, bl, am, bm, y.data_ptr(),
                 M, K, N, r, int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), p.kind, p.split, p.zsplit,
                 float(scale), build.stream_ptr(dev))
    build.check(err, "dual_lora_matmul")
    dual_lora_matmul.launches += 1
    if tile == "mma":
        dual_lora_matmul.launches_mma += 1
    else:
        dual_lora_matmul.launches_f32 += 1
    return y


dual_lora_matmul.launches = 0
dual_lora_matmul.launches_mma = 0
dual_lora_matmul.launches_f32 = 0

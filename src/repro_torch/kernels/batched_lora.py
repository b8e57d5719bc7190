"""Batched multi-tenant LoRA matmuls: the wrappers of ``csrc/batched_lora.cu``
and ``csrc/batched_dual_lora.cu``.

Port of the Pallas kernel ``repro/kernels/batched_lora.py::
batched_lora_matmul``: ``y[i] = x[i]·W + α·x[i]·A[g[i]]·B[g[i]]`` with
per-row client ids over stacked banks, an optional per-client rank mask
(ragged banks) and optional int8 banks with per-client scales.  The
kernel computes the base product itself (fp32 accumulation) and rounds
once in its epilogue.  CPU tensors run the plain version
(:func:`batched_lora_matmul_ref`); CUDA tensors launch the kernel or
raise; meta tensors take the meta route (``kernels/meta.py``).  The kernel has two tiles, picked by dtype
(``kernels/lora_tile.py``): bf16 x with bf16 W runs the tensor-core tile
(``csrc/lora_mma.cuh``, K and N multiples of 8, 16-byte aligned x and W)
under a launch plan chosen from the shape, anything else the fp32
CUDA-core tile.  ``batched_lora_matmul.launches`` counts launches, and
``launches_mma`` / ``launches_f32`` split them by tile.

:func:`batched_dual_lora_matmul` is the port of the Pallas kernel of the
same name: per-row Eq. 7 over a personalized bank and one global pair,
each row with its own fusion weights.  It takes its tile by the same rule:
on the tensor-core tile the two pairs run as two shrinks and one
concatenated LoRA operand of rank 2·16·ceil(r/16), per row
``[α·w1·z | α·w2·z]`` against ``[B1[g]; B2]`` (``csrc/batched_dual_lora.cu``).
No path of the reference package calls it (its registry merges Eq. 7 at
``register_dual`` and serves the merged bank), so it runs at its own entry
point only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build, lora_tile, meta
from repro_torch.kernels.ref import (batched_dual_lora_matmul_ref,
                                     batched_lora_matmul_ref)

__all__ = ["batched_lora_matmul", "batched_lora_matmul_ref",
           "batched_dual_lora_matmul", "batched_dual_lora_matmul_ref"]

MAX_RANK = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("batched_lora")
    fn = lib.batched_lora_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [_I] * 11 + [_F, _P]
        fn.restype = _I
    return fn


def _dual_lib():
    lib = build.load("batched_dual_lora")
    fn = lib.batched_dual_lora_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 10 + [_F, _P]
        fn.restype = _I
    return fn


def _check(name, t, dtypes, shape, device):
    if (t.dtype not in dtypes or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {'/'.join(map(str, dtypes))} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def tile_scratch_sizes(p: lora_tile.Plan, tile: str, M: int, N: int,
                       C: int, r: int, z_given: bool, *, pairs: int = 1,
                       extra: Sequence[int] = ()) -> list:
    """The fp32 element counts of :func:`tile_scratch`'s parts (z, zpart,
    ypart, zl, bl, then ``extra``), each rounded up to 16 bytes; z is 0
    when the caller gives it (``z_given``)."""
    mma = tile == "mma"
    nq = pairs * -(-r // 16)
    sizes = [0 if z_given else pairs * M * r,                    # z
             pairs * p.zsplit * M * r if mma and p.zsplit > 1 else 0,
             p.split * M * N if mma and p.split > 1 else 0,     # ypart
             M * nq * 32 if mma and p.split == 1 else 0,        # zl (bf16)
             C * nq * 16 * N if mma and p.split == 1 else 0,    # bl (bf16)
             *(n if mma else 0 for n in extra)]
    return [-(-n // 4) * 4 for n in sizes]        # each part 16-byte aligned


def tile_scratch(p: lora_tile.Plan, tile: str, M: int, N: int, C: int,
                 r: int, device, z: Optional[torch.Tensor] = None, *,
                 pairs: int = 1, extra: Sequence[int] = ()) -> tuple:
    """One allocation for the tensor-core tile's scratch (``lmma::run`` in
    ``csrc/lora_mma.cuh``) and for z (M, r) fp32 unless ``z`` is given:
    returns (z, zpart, ypart, zl, bl), the last four as pointers or None
    where the plan needs none: the shrink's fp32 partials (zsplit, M, r),
    the base product's fp32 partials (split, M, N), and the LoRA term's
    bf16 operand rows zl (M, nq, 64) and bl (C, nq, 32, N), nq =
    ceil(r / 16).  The fp32 tile needs z only.

    ``pairs`` = 2 (``batched_dual_lora_matmul``): z is (2, M, r) and the
    partials (2, zsplit, M, r), one per shrink (personalized, global), and
    the LoRA operand is the pair's concatenation of 2·nq rank chunks (zl
    (M, 2nq, 64), bl (C, 2nq, 32, N), C counting any extra slot).
    ``extra``: fp32 element counts of further parts the tensor-core tile's
    caller needs; their pointers (None on the fp32 tile) follow bl."""
    sizes = tile_scratch_sizes(p, tile, M, N, C, r, z is not None,
                               pairs=pairs, extra=extra)
    if sum(sizes) == 0:
        return (z, *[None] * (len(sizes) - 1))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    if z is None:
        z = buf[:pairs * M * r].view((pairs, M, r) if pairs > 1 else (M, r))
    ptrs, off = [], sizes[0]
    for n in sizes[1:]:
        ptrs.append(buf.data_ptr() + 4 * off if n else None)
        off += n
    return (z, *ptrs)


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
    if x.device.type not in ("cuda", "meta"):
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
    tile = lora_tile.lora_tile(x.dtype, w.dtype)
    if tile == "mma":
        lora_tile.check_mma_tile(x, w)
    if dev.type == "meta":
        meta.record("batched_lora_matmul", meta.batched_lora_cost(
            M, K, N, C, r, x.dtype, w.dtype, a.element_size()))
        return meta.empty((M, N), x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y
    p = lora_tile.plan(M, N, K)
    z, zpart, ypart, zl, bl = tile_scratch(p, tile, M, N, C, r, dev)
    err = _lib()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 a_scale.data_ptr() if quant else None,
                 b_scale.data_ptr() if quant else None,
                 ranks.data_ptr() if ranks is not None else None,
                 adapter_ids.data_ptr(), z.data_ptr(), zpart, ypart, zl, bl,
                 y.data_ptr(), M, K, N, C, r, int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), int(quant), p.kind, p.split,
                 p.zsplit, float(scale), build.stream_ptr(dev))
    build.check(err, "batched_lora_matmul")
    batched_lora_matmul.launches += 1
    if tile == "mma":
        batched_lora_matmul.launches_mma += 1
    else:
        batched_lora_matmul.launches_f32 += 1
    return y


batched_lora_matmul.launches = 0
batched_lora_matmul.launches_mma = 0
batched_lora_matmul.launches_f32 = 0


def batched_dual_lora_matmul(x: torch.Tensor, w: torch.Tensor,
                             a1: torch.Tensor, b1: torch.Tensor,
                             a2: torch.Tensor, b2: torch.Tensor,
                             adapter_ids: torch.Tensor,
                             fusion_w: torch.Tensor,
                             scale: float = 1.0) -> torch.Tensor:
    """x: (M, K), w: (K, N), a1: (C, K, r) and b1: (C, r, N) fp32 (the
    personalized bank), a2: (K, r) and b2: (r, N) fp32 (the global pair),
    adapter_ids: (M,) int32, fusion_w: (M, 2) fp32 per-row ``[w1, w2]`` ->
    (M, N) in x's dtype.  Forward only."""
    if x.dim() != 2 or w.dim() != 2 or a1.dim() != 3 or b1.dim() != 3:
        raise ValueError("x (M, K), w (K, N), a1 (C, K, r), b1 (C, r, N)")
    M, K = x.shape
    N = w.shape[1]
    C, _, r = a1.shape
    if (w.shape[0] != K or tuple(a1.shape) != (C, K, r)
            or tuple(b1.shape) != (C, r, N) or tuple(a2.shape) != (K, r)
            or tuple(b2.shape) != (r, N)
            or tuple(fusion_w.shape) != (M, 2)):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a1 {tuple(a1.shape)}, b1 "
                         f"{tuple(b1.shape)}, a2 {tuple(a2.shape)}, b2 "
                         f"{tuple(b2.shape)}, fusion_w "
                         f"{tuple(fusion_w.shape)}")
    if x.device.type == "cpu":
        return batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, adapter_ids,
                                            fusion_w, scale)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no batched_dual_lora_matmul kernel for {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a1, b1, a2, b2, fusion_w)):
        raise RuntimeError("batched_dual_lora_matmul is forward only; call "
                           "it under torch.no_grad()")
    dev = x.device
    fl = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    _check("x", x, fl, (M, K), dev)
    _check("w", w, fl, (K, N), dev)
    for name, t, shape in (("a1", a1, (C, K, r)), ("b1", b1, (C, r, N)),
                           ("a2", a2, (K, r)), ("b2", b2, (r, N)),
                           ("fusion_w", fusion_w, (M, 2))):
        _check(name, t, f32, shape, dev)
    _check("adapter_ids", adapter_ids, (torch.int32,), (M,), dev)
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    tile = lora_tile.lora_tile(x.dtype, w.dtype)
    if tile == "mma":
        lora_tile.check_mma_tile(x, w)
    if dev.type == "meta":
        meta.record("batched_dual_lora_matmul", meta.batched_dual_lora_cost(
            M, K, N, C, r, x.dtype, w.dtype))
        return meta.empty((M, N), x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y
    p = lora_tile.plan(M, N, K)
    # slot C of bl holds the global pair alone, for rows outside the bank;
    # the extra part is each row's slot (int32)
    z, zpart, ypart, zl, bl, slot = tile_scratch(
        p, tile, M, N, C + 1, r, dev, pairs=2, extra=(M,))
    err = _dual_lib()(x.data_ptr(), w.data_ptr(), a1.data_ptr(),
                      b1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                      adapter_ids.data_ptr(), fusion_w.data_ptr(),
                      z.data_ptr(), zpart, ypart, zl, bl, slot,
                      y.data_ptr(), M, K, N, C, r,
                      int(x.dtype == torch.bfloat16),
                      int(w.dtype == torch.bfloat16), p.kind, p.split,
                      p.zsplit, float(scale), build.stream_ptr(dev))
    build.check(err, "batched_dual_lora_matmul")
    batched_dual_lora_matmul.launches += 1
    if tile == "mma":
        batched_dual_lora_matmul.launches_mma += 1
    else:
        batched_dual_lora_matmul.launches_f32 += 1
    return y


batched_dual_lora_matmul.launches = 0
batched_dual_lora_matmul.launches_mma = 0
batched_dual_lora_matmul.launches_f32 = 0

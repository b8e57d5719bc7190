"""Fused single-tenant LoRA matmul: the wrapper of ``csrc/lora_matmul.cu``.

Port of the Pallas kernel ``repro/kernels/lora_matmul.py::lora_matmul``:
``y = x·W + α·(x·A)·B`` with fp32 accumulation and one rounding to x's
dtype.  It carries every LoRA projection of a training forward, so it is
differentiable: the launch is the operator ``repro_torch::lora_matmul``
(a ``torch.library.custom_op``), whose backward is plain PyTorch,
:func:`lora_matmul_backward` (the reference has no backward kernel
either; its gradients come from autodiff outside the Pallas call).
``W`` is frozen and gets no gradient.  Being an operator of its own, the
launch is one op to a ``TorchDispatchMode``: the ``"dots"`` recomputation
policy (``models/model.py``) saves its outputs, as the reference's
``dots_with_no_batch_dims_saveable`` saves a projection's, instead of
launching the kernel again in backward.

CPU tensors run the plain version (:func:`lora_matmul_ref`, differentiated
by autograd); CUDA tensors launch the kernel or raise; meta tensors take
the operator's fake implementation (``kernels/meta.py``: empty outputs,
the launch's cost recorded), and their backward is
:func:`lora_matmul_backward` on meta tensors, plain ops like any other.
The kernel has two
tiles, picked by dtype (``kernels/lora_tile.py``): bf16 x with bf16 W runs
the tensor-core tile (``csrc/lora_mma.cuh``, K and N multiples of 8,
16-byte aligned x and W) under a launch plan chosen from the shape,
anything else the fp32 CUDA-core tile.  Both keep z = x·A in fp32.
``lora_matmul.launches`` counts launches, and ``launches_mma`` /
``launches_f32`` split them by tile.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, lora_tile, meta
from repro_torch.kernels.batched_lora import MAX_RANK, _check, tile_scratch
from repro_torch.kernels.ref import lora_matmul_ref

__all__ = ["lora_matmul", "lora_matmul_ref", "lora_matmul_backward",
           "lora_matmul_op"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("lora_matmul")
    fn = lib.lora_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 9 + [_F, _P]
        fn.restype = _I
    return fn


def _checked(x, w, a, b) -> str:
    """The launch's checks; returns its tile."""
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    dev = x.device
    fl = (torch.float32, torch.bfloat16)
    _check("x", x, fl, (M, K), dev)
    _check("w", w, fl, (K, N), dev)
    _check("a", a, (torch.float32,), (K, r), dev)
    _check("b", b, (torch.float32,), (r, N), dev)
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    tile = lora_tile.lora_tile(x.dtype, w.dtype)
    if tile == "mma":
        lora_tile.check_mma_tile(x, w)
    return tile


def _launch(x, w, a, b, scale: float):
    """One launch on the card: returns (y (M, N) in x's dtype, z = x·A
    (M, r) fp32)."""
    tile = _checked(x, w, a, b)
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    z = torch.empty((M, r), dtype=torch.float32, device=dev)
    if M == 0:
        return y, z
    p = lora_tile.plan(M, N, K)
    # z is saved for the backward: the scratch gets its own buffer
    _, zpart, ypart, zl, bl = tile_scratch(p, tile, M, N, 1, r, dev, z=z)
    err = _lib()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                 z.data_ptr(), zpart, ypart, zl, bl, y.data_ptr(), M, K, N, r,
                 int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
                 p.kind, p.split, p.zsplit, float(scale),
                 build.stream_ptr(dev))
    build.check(err, "lora_matmul")
    lora_matmul.launches += 1
    if tile == "mma":
        lora_matmul.launches_mma += 1
    else:
        lora_matmul.launches_f32 += 1
    return y, z


@torch.library.custom_op("repro_torch::lora_matmul", mutates_args=(),
                         device_types="cuda")
def lora_matmul_op(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_launch` as an operator: (y, z), differentiable in x, a and
    b through :func:`lora_matmul_backward`."""
    return _launch(x, w, a, b, scale)


def lora_matmul_backward(x, w, a, b, z, dy, scale: float,
                         needs=(True, True, True)):
    """Gradients (dx, dA, dB) of ``y = x·W + s·z·B`` with ``z = x·A``, for
    the output gradient ``dy``; ``needs`` says which of the three to
    compute (the others are None).  Plain PyTorch, reusing the forward's
    fp32 ``z``: dB = s·zᵀ·dy, dz = s·dy·Bᵀ, dA = xᵀ·dz (fp32, as the
    reference's fp32 LoRA branch gives them) and dx = dy·Wᵀ + dz·Aᵀ (the
    base term in dy's dtype, as the plain dense layer's autograd computes
    it).  ``W`` is frozen and gets no gradient."""
    need_x, need_a, need_b = needs
    dyf = dy.float()
    dz = scale * torch.matmul(dyf, b.t()) if (need_x or need_a) else None
    db = scale * torch.matmul(z.t(), dyf) if need_b else None
    da = torch.matmul(x.float().t(), dz) if need_a else None
    dx = (torch.matmul(dy, w.t().to(dy.dtype))
          + torch.matmul(dz, a.t()).to(dy.dtype)) if need_x else None
    return dx, da, db


@lora_matmul_op.register_fake
def _lora_matmul_fake(x, w, a, b, scale):
    """The launch's outputs, empty, after its checks; on the meta device
    (the dry run) its cost is recorded (``kernels/meta.py``)."""
    _checked(x, w, a, b)
    (M, K), N, r = x.shape, w.shape[1], a.shape[1]
    if x.device.type == "meta":
        meta.record("lora_matmul", meta.lora_cost(M, K, N, r, x.dtype,
                                                  w.dtype))
    return x.new_empty((M, N)), x.new_empty((M, r), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    x, w, a, b, scale = inputs
    ctx.save_for_backward(x, w, a, b, output[1])
    ctx.mark_non_differentiable(output[1])
    ctx.scale = scale


def _backward(ctx, dy, _dz):
    x, w, a, b, z = ctx.saved_tensors
    need = ctx.needs_input_grad
    if need[1]:
        raise RuntimeError("lora_matmul: the base weight W is frozen and "
                           "gets no gradient")
    dx, da, db = lora_matmul_backward(x, w, a, b, z, dy, ctx.scale,
                                      (need[0], need[2], need[3]))
    return dx, None, da, db, None


lora_matmul_op.register_autograd(_backward, setup_context=_setup_context)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x: (M, K), w: (K, N), a: (K, r) fp32, b: (r, N) fp32 -> (M, N) in
    x's dtype; differentiable in x, a and b."""
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("x (M, K), w (K, N), a (K, r), b (r, N)")
    if (w.shape[0] != x.shape[1] or a.shape[0] != x.shape[1]
            or b.shape != (a.shape[1], w.shape[1])):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no lora_matmul kernel for {x.device}")
    return lora_matmul_op(x, w, a, b, float(scale))[0]


lora_matmul.launches = 0
lora_matmul.launches_mma = 0
lora_matmul.launches_f32 = 0

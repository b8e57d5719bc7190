"""Symmetric int8 quantization for paged K/V pools and adapter banks.

Values are int8 in [-127, 127] with one fp32 scale per group, the group
being the dims amax runs over: the head dim for K/V (one scale per block,
position and kv-head), the whole factor for adapter banks (one scale per
client and factor).  ``scale = max(amax, 1e-12) / 127`` so all-zero groups
round-trip to exact zeros.  Dequantization happens at the read site.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

INT8_MAX = 127.0
_SCALE_FLOOR = 1e-12

Dims = Union[int, Sequence[int]]


def quantize_int8(x: torch.Tensor, dim: Dims
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32)``; ``scale`` has ``x``'s shape with ``dim``
    removed."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=_SCALE_FLOOR) / INT8_MAX
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale.squeeze(dims)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dim: Dims
                    ) -> torch.Tensor:
    dims = sorted((dim,) if isinstance(dim, int) else tuple(dim))
    s = scale
    for d in dims:
        s = s.unsqueeze(d)
    return q.float() * s

"""PyTorch/CUDA port of the FDLoRA serving stack.

Layout mirrors the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``).  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; asking for a card
that is not there raises.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev

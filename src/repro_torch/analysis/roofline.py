"""Roofline terms of one step on the card.

Port of ``repro/analysis/roofline.py`` for an NVIDIA H100 SXM5 80GB HBM3
at its 700 W limit.  Three terms per (arch × shape × cards), in seconds:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / link rate (0 on one card)

The peaks are the data sheet's: 989 TFLOP/s bf16 dense on the tensor
cores, 67 TFLOP/s fp32 outside them, 3.35 TB/s of HBM3.
``chip_smoke.py``'s kernel bounds read the same three peaks from here.

FLOPs and bytes come from the port's dry run (``launch/dryrun.py``), which
walks a step on the meta device; nothing in the port emits HLO, so the
reference's HLO parser has no counterpart.  Collectives wait for the
port's mesh (and the NVLink rate with it): until then ``chips`` must be 1
and the collective term is 0; :func:`ring_bytes` keeps the reference's
ring factors for that day.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
FP32_FLOPS = 67e12           # fp32, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card

RING_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def ring_bytes(op: str, out_bytes: float, group: int) -> float:
    """Bytes each member of a ``group`` moves for collective ``op`` whose
    output is ``out_bytes`` long, by the ring algorithm (g = group size):
    all-reduce 2·S·(g-1)/g, all-gather S·(g-1)/g, reduce-scatter S·(g-1)
    (its input is g·S), all-to-all S·(g-1)/g, collective-permute S."""
    g = max(int(group), 1)
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    if op in ("all-gather", "all-to-all"):
        return out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {op!r}; one of {RING_OPS}")


@dataclasses.dataclass
class Roofline:
    flops: float                # FLOPs per card
    hbm_bytes: float            # bytes per card to and from HBM
    collective_bytes: float     # bytes per card over NVLink
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    n_collectives: int = 0
    coll_by_op: Optional[Dict[str, float]] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(flops: float, hbm_bytes: float, chips: int = 1,
            model_flops: float = 0.0) -> Roofline:
    """The three terms for one step of ``flops`` and ``hbm_bytes`` per
    card.  ``useful_ratio`` is ``model_flops`` (6·N·D or 2·N·D) over the
    FLOPs counted.  One card only until the port has a mesh."""
    if chips != 1:
        raise ValueError(f"chips={chips}: the port has no mesh yet, so its "
                         "roofline is for one card")
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    coll_s = 0.0
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    total = flops * chips
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    collective_bytes=0.0, chips=chips, compute_s=compute_s,
                    memory_s=memory_s, collective_s=coll_s,
                    dominant=dominant, model_flops=float(model_flops),
                    useful_ratio=model_flops / total if total else 0.0,
                    n_collectives=0, coll_by_op={})


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D for a train step (forward and backward)."""
    return 6.0 * cfg.count_active_params() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    """2·N_active·D for a forward only (prefill, decode)."""
    return 2.0 * cfg.count_active_params() * tokens

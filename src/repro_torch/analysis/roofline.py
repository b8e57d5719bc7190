"""Roofline terms of one step on the card.

Port of ``repro/analysis/roofline.py`` for an NVIDIA H100 SXM5 80GB HBM3
at its 700 W limit.  Three terms per (arch × shape × cards), in seconds:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / link rate

The peaks are the data sheet's: 989 TFLOP/s bf16 dense on the tensor
cores, 67 TFLOP/s fp32 outside them, 3.35 TB/s of HBM3.
``chip_smoke.py``'s kernel bounds read the same three peaks from here.

FLOPs and bytes come from the port's dry run (``launch/dryrun.py``), which
walks a step on the meta device; nothing in the port emits HLO, so the
reference's HLO parser has no counterpart.  The collective bytes come
from a log of :class:`Collective` records instead, which
``launch/mesh.all_reduce`` appends to as a round issues its collectives;
each record's per-card bytes are the reference's ring factors
(:func:`ring_bytes`).  The link rates are the data sheet's, not measured
ones: NVLink 4 at 450 GB/s a direction between the 8 cards of a node,
400 Gb/s NDR InfiniBand (50 GB/s) per card beyond it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
FP32_FLOPS = 67e12           # fp32, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card a direction, NVLink 4
NODE_CARDS = 8               # cards one NVLink switch joins
NDR_BW = 50e9                # bytes/s per card, 400 Gb/s NDR InfiniBand

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
class Collective:
    """One collective a rank issued: ``op`` (one of :data:`RING_OPS`) over
    the group of mesh axis ``axis`` (``group`` ranks), ``bytes`` of
    payload, ``per_card_bytes`` each member moves by the ring algorithm,
    and the host's ``ms`` around the call (the device synchronised on
    both sides)."""
    op: str
    axis: str
    group: int
    bytes: int
    per_card_bytes: float
    ms: float = 0.0


def link_rate(chips: int) -> float:
    """The data sheet's bytes/s per card for a collective among ``chips``
    cards: NVLink inside one node, NDR InfiniBand once a ring leaves it."""
    return NVLINK_BW if chips <= NODE_CARDS else NDR_BW


@dataclasses.dataclass
class Roofline:
    flops: float                # FLOPs per card
    hbm_bytes: float            # bytes per card to and from HBM
    collective_bytes: float     # bytes per card over the links
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
            model_flops: float = 0.0,
            collectives: Sequence[Collective] = ()) -> Roofline:
    """The three terms for one step of ``flops`` and ``hbm_bytes`` per
    card on ``chips`` cards.  ``useful_ratio`` is ``model_flops`` (6·N·D
    or 2·N·D, over all cards) over the FLOPs counted on all cards.  The
    collective term sums the per-card bytes of ``collectives`` (one
    rank's log of the step) over the data sheet's link rate for
    ``chips`` cards (:func:`link_rate`); with no log it is 0."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    per_card = float(sum(c.per_card_bytes for c in collectives))
    by_op: Dict[str, float] = {}
    for c in collectives:
        by_op[c.op] = by_op.get(c.op, 0.0) + c.per_card_bytes
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    coll_s = per_card / link_rate(chips)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    total = flops * chips
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    collective_bytes=per_card, chips=chips,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dominant,
                    model_flops=float(model_flops),
                    useful_ratio=model_flops / total if total else 0.0,
                    n_collectives=len(collectives), coll_by_op=by_op)


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D for a train step (forward and backward)."""
    return 6.0 * cfg.count_active_params() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    """2·N_active·D for a forward only (prefill, decode)."""
    return 2.0 * cfg.count_active_params() * tokens

"""Multi-tenant adapter registry: a fixed-capacity bank on the device + LRU.

Port of ``repro/serving/registry.py`` (single-rank fp32 banks).  The bank
mirrors one adapter tree with a client axis on every factor:

    single client:  a: (d_in, r)      b: (r, d_out)       per layer
    bank:           a: (C, d_in, r)   b: (C, r, d_out)    per layer

and each request's row gathers its client's slot (``layers.lora_delta`` on
the torch path, the batched-LoRA kernel on the card).  Capacity is fixed;
registering beyond it evicts the least-recently-served client.  Slots are
written IN PLACE, so a live session sees a re-registered client at its
next dispatch; ``bank_epoch`` counts content changes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.dual_lora import check_rank_agreement, merge
from repro_torch.core.lora import block_target_shapes, tree_leaves
from repro_torch.serving.scheduler import PRIORITY_CLASSES

Params = Any


class AdapterRegistry:
    """Registers/evicts client adapter trees into a stacked serving bank.

    ``bank_dtype="int8"`` and ``ranks=[...]`` (ragged-rank buckets) are
    options of the reference registry that this slice of the port does not
    serve yet; both raise ``NotImplementedError``."""

    def __init__(self, cfg, capacity: int, rank: Optional[int] = None,
                 bank_dtype: str = "f32",
                 ranks: Optional[Sequence[int]] = None, device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if bank_dtype not in ("f32", "int8"):
            raise ValueError(
                f"bank_dtype must be 'f32' or 'int8', got {bank_dtype!r}")
        if bank_dtype == "int8":
            raise NotImplementedError(
                "int8 adapter banks are a later slice of the port (ROADMAP: "
                "ragged and int8 banks)")
        if ranks is not None:
            raise NotImplementedError(
                "ragged-rank adapter banks are a later slice of the port "
                "(ROADMAP: ragged and int8 banks)")
        self.capacity = capacity
        self.bank_dtype = bank_dtype
        self.device = resolve_device(device)
        self.rank = rank or cfg.lora_rank
        self.evictions = 0
        self.bank_epoch = 0          # bumped on every bank content change
        shapes = block_target_shapes(cfg)
        r = self.rank
        self._bank: Params = {"layers": [
            {part: {t: {"a": torch.zeros((capacity, din, r),
                                         device=self.device),
                        "b": torch.zeros((capacity, r, dout),
                                         device=self.device)}
                    for t, (din, dout) in tmap.items()}
             for part, tmap in shapes.items()}
            for _ in range(cfg.n_layers)]}
        # (path, per-client shape) of every leaf, for validating trees
        self._template = [(p, tuple(leaf.shape[1:]))
                          for p, leaf in tree_leaves(self._bank)]
        self._lru: "OrderedDict[Any, int]" = OrderedDict()  # client -> slot
        self._free: List[int] = list(range(capacity))
        self._versions: Dict[Any, int] = {}
        self._default_priority: Dict[Any, str] = {}

    # ---- bookkeeping ------------------------------------------------------
    def __contains__(self, client_id) -> bool:
        return client_id in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def resident(self) -> List[Any]:
        """Client ids, least- to most-recently used."""
        return list(self._lru)

    def _grab_slot(self, client_id) -> int:
        if client_id in self._lru:
            return self._lru[client_id]
        if self._free:
            return self._free.pop(0)
        evicted, slot = self._lru.popitem(last=False)   # least recent
        self._default_priority.pop(evicted, None)
        self.evictions += 1
        return slot

    def _validate_tree(self, adapters: Params, what: str = "adapters"):
        """Check ``adapters`` against the bank layout BEFORE any write, naming
        the first leaf that does not fit; returns its leaves in order."""
        leaves = tree_leaves(adapters)
        got = {p for p, _ in leaves}
        want = {p for p, _ in self._template}
        if got != want:
            missing, extra = sorted(want - got), sorted(got - want)
            raise ValueError(
                f"{what} tree structure does not match the adapter bank "
                f"template" + (f"; missing leaves: {missing}" if missing
                               else "")
                + (f"; unexpected leaves: {extra}" if extra else ""))
        for (path, shape), (_, leaf) in zip(self._template, leaves):
            if tuple(leaf.shape) != shape:
                raise ValueError(
                    f"{what} leaf {path} has shape {tuple(leaf.shape)}; the "
                    f"bank template expects {shape}")
        return [leaf for _, leaf in leaves]

    # ---- writes -----------------------------------------------------------
    def register(self, client_id, adapters: Params,
                 default_priority: Optional[str] = None) -> int:
        """Install (or refresh) a client's adapter tree (per-layer ``{"a",
        "b"}`` leaves as tensors or numpy arrays); returns its slot.
        ``default_priority`` names the SLA class for the client's requests
        that set none; ``None`` keeps any earlier default."""
        leaves = self._validate_tree(adapters)
        if default_priority is not None:
            if default_priority not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown default_priority {default_priority!r} "
                    f"(have {sorted(PRIORITY_CLASSES)})")
            self._default_priority[client_id] = default_priority
        slot = self._grab_slot(client_id)
        for (_, bank_leaf), leaf in zip(tree_leaves(self._bank), leaves):
            bank_leaf[slot].copy_(torch.as_tensor(leaf, dtype=torch.float32))
        self._lru[client_id] = slot
        self._lru.move_to_end(client_id)
        self._versions[client_id] = self._versions.get(client_id, 0) + 1
        self.bank_epoch += 1
        return slot

    def register_dual(self, client_id, personalized: Params, global_: Params,
                      fusion_weights,
                      default_priority: Optional[str] = None) -> int:
        """Fuse a dual-LoRA state by Eq. 7 and install the result."""
        check_rank_agreement(personalized, global_)
        self._validate_tree(personalized, what="personalized adapters")
        self._validate_tree(global_, what="global adapters")
        fused = merge(personalized, global_, fusion_weights)
        return self.register(client_id, fused,
                             default_priority=default_priority)

    def evict(self, client_id) -> None:
        """Drop a client; its slot returns to the free list."""
        if client_id not in self._lru:
            raise KeyError(f"client {client_id!r} is not resident "
                           f"(resident: {self.resident})")
        self._free.append(self._lru.pop(client_id))
        self._default_priority.pop(client_id, None)

    # ---- reads ------------------------------------------------------------
    def acquire(self, client_id) -> int:
        """Slot for a request's client (touches LRU recency)."""
        if client_id not in self._lru:
            raise KeyError(f"client {client_id!r} is not resident "
                           f"(resident: {self.resident})")
        self._lru.move_to_end(client_id)
        return self._lru[client_id]

    def default_priority(self, client_id) -> Optional[str]:
        return self._default_priority.get(client_id)

    def version(self, client_id) -> int:
        """Monotone per-client weight version, bumped on every register."""
        if client_id not in self._versions:
            raise KeyError(f"client {client_id!r} was never registered "
                           f"(resident: {self.resident})")
        return self._versions[client_id]

    def bank(self) -> Params:
        """The stacked adapter tree: per layer, leaves (C, d_in, r) /
        (C, r, d_out) fp32 on the registry's device."""
        return self._bank

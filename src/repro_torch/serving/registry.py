"""Multi-tenant adapter registry: a fixed-capacity bank on the device + LRU.

Port of ``repro/serving/registry.py``.  The bank mirrors one adapter tree
with a client axis on every factor:

    single client:  a: (d_in, r)      b: (r, d_out)       per layer
    bank:           a: (C, d_in, r)   b: (C, r, d_out)    per layer

and each request's row gathers its client's slot (``layers.lora_delta`` on
the torch path, the batched-LoRA kernel on the card).

Heterogeneous ranks (``ranks=[r0 < r1 < ...]``) split the capacity into
one bucket per rank: a client registering at rank r lands in the smallest
bucket whose rank covers r, zero-padded up to the bucket rank (zero rank
columns are inert, so a padded client serves its native-rank output).
:meth:`AdapterRegistry.bank` then gives a per-bucket LIST at each factor
leaf, in global-slot order, as the reference does.
``bank_dtype="int8"`` stores the factors quantized with one fp32 scale per
(layer, client) and factor (``a_scale``/``b_scale`` (C,) leaves beside each
pair), computed at :meth:`register`.

Capacity is fixed; registering beyond it evicts the least-recently-served
client of the same bucket.  Slots are written IN PLACE, so a live session
sees a re-registered client at its next dispatch; ``bank_epoch`` counts
content changes.  :meth:`kernel_bank` is the layout the batched kernel
reads (buckets concatenated at the largest rank plus a per-slot rank
vector), built once per ``bank_epoch`` rather than in every projection.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.dual_lora import check_rank_agreement, merge
from repro_torch.core.lora import (adapter_specs, block_target_shapes,
                                   tree_leaves)
from repro_torch.core.partition import P
from repro_torch.kernels.ops import concat_buckets
from repro_torch.kernels.quant import quantize_int8
from repro_torch.models import tensor_parallel as tpl
from repro_torch.serving.scheduler import PRIORITY_CLASSES

Params = Any


def _is_pair(node) -> bool:
    """An adapter target's leaf dict ({"a", "b"}) in a client tree."""
    return isinstance(node, dict) and set(node) == {"a", "b"}


def _targets(tree):
    """``[(layer index, part, target, node), ...]`` of a per-layer tree."""
    return [(i, part, t, node) for i, layer in enumerate(tree["layers"])
            for part, tmap in layer.items() for t, node in tmap.items()]


def _zip_banks(banks: Sequence[Params]) -> Params:
    """Per-bucket bank trees -> one tree whose factor leaves are per-bucket
    lists (``{"a": [a_b0, a_b1, ...], ...}`` at every target)."""
    first = banks[0]
    if isinstance(first, list):
        return [_zip_banks([bk[i] for bk in banks])
                for i in range(len(first))]
    if all(isinstance(v, (dict, list)) for v in first.values()):
        return {k: _zip_banks([bk[k] for bk in banks]) for k in first}
    return {k: [bk[k] for bk in banks] for k in first}


def model_shard(bank: Params, cfg, size: int, rank: int) -> Params:
    """Rank ``rank``'s shard of a bank over a ``size``-way ``"model"``
    axis: per target, the factor dim ``core/lora.adapter_specs`` splits
    (B's output columns for wq/wk/wv/w_up/w_gate, by heads within each
    segment for in_proj, A's input rows for wo/w_out/out_proj;
    ``tensor_parallel.shard_leaf``), after the client axis, in every
    bucket of a ragged bank's lists and in its kernel view alike; int8
    scales (one per (layer,
    client) and factor) and the kernel view's ``ranks`` stay whole, so a
    quantized shard dequantizes as the whole factor does.  Copies: the
    shard of a bank epoch stays as it was when the bank is written in
    place."""
    specs = adapter_specs(cfg)

    def take(spec, leaf):
        if isinstance(leaf, (list, tuple)):
            return [take(spec, t) for t in leaf]
        return tpl.shard_leaf(leaf, P(None, *spec), size, rank)

    return {"layers": [
        {part: {t: {k: take(specs["layers"][i][part][t][k], v)
                    if k in ("a", "b") else v for k, v in node.items()}
                for t, node in tmap.items()}
         for part, tmap in layer.items()}
        for i, layer in enumerate(bank["layers"])]}


class AdapterRegistry:
    """Registers/evicts client adapter trees into a stacked serving bank.

    ``ranks=[r0, r1, ...]`` enables ragged-rank mode (buckets sized as
    equally as integer division allows, the remainder to the small ranks);
    without it the registry is one bucket at ``rank or cfg.lora_rank``.
    ``bank_dtype="int8"`` quantizes the resident bank; registered trees
    stay fp32 at the API."""

    def __init__(self, cfg, capacity: int, rank: Optional[int] = None,
                 bank_dtype: str = "f32",
                 ranks: Optional[Sequence[int]] = None, device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if bank_dtype not in ("f32", "int8"):
            raise ValueError(
                f"bank_dtype must be 'f32' or 'int8', got {bank_dtype!r}")
        if ranks is not None:
            if rank is not None:
                raise ValueError("pass either rank= or ranks=, not both")
            ranks = sorted({int(r) for r in ranks})
            if not ranks or ranks[0] < 1:
                raise ValueError(f"ranks must be positive ints, got {ranks!r}")
            if capacity < len(ranks):
                raise ValueError(
                    f"capacity {capacity} cannot host {len(ranks)} rank "
                    f"buckets (need >= 1 slot per bucket)")
        self.capacity = capacity
        self.bank_dtype = bank_dtype
        self.device = resolve_device(device)
        self.ragged = ranks is not None
        self.evictions = 0
        self.bank_epoch = 0          # bumped on every bank content change
        self._cfg = cfg
        if self.ragged:
            base, rem = divmod(capacity, len(ranks))
            self.bucket_ranks: List[int] = list(ranks)
            self.bucket_sizes: List[int] = [base + (1 if i < rem else 0)
                                            for i in range(len(ranks))]
        else:
            self.bucket_ranks = [rank or cfg.lora_rank]
            self.bucket_sizes = [capacity]
        self.bucket_offsets: List[int] = [
            sum(self.bucket_sizes[:i]) for i in range(len(self.bucket_sizes))]
        # zero banks: a zero adapter is a no-op, so free slots serve the
        # frozen base model
        self._banks: List[Params] = [
            self._zero_bank(rb, sz)
            for rb, sz in zip(self.bucket_ranks, self.bucket_sizes)]
        # writes are in place, so the zipped view stays current
        self._bank = (self._banks[0] if len(self._banks) == 1
                      else _zip_banks(self._banks))
        self._kernel_bank: Optional[Tuple[int, Params]] = None
        self._lru: "OrderedDict[Any, int]" = OrderedDict()  # client -> slot
        self._free: List[List[int]] = [list(range(sz))
                                       for sz in self.bucket_sizes]
        self._versions: Dict[Any, int] = {}
        self._client_rank: Dict[Any, int] = {}   # native (pre-pad) rank
        self._default_priority: Dict[Any, str] = {}

    def _zero_bank(self, rank: int, cap: int) -> Params:
        """One bucket: per layer and target ``{"a": (cap, d_in, rank), "b":
        (cap, rank, d_out)}`` (int8 plus (cap,) fp32 scales when
        quantized)."""
        q = self.bank_dtype == "int8"
        fdt = torch.int8 if q else torch.float32
        dev = self.device

        def pair(din, dout):
            out = {"a": torch.zeros((cap, din, rank), dtype=fdt, device=dev),
                   "b": torch.zeros((cap, rank, dout), dtype=fdt, device=dev)}
            if q:
                out["a_scale"] = torch.zeros((cap,), device=dev)
                out["b_scale"] = torch.zeros((cap,), device=dev)
            return out
        return {"layers": [
            {part: {t: pair(din, dout) for t, (din, dout) in tmap.items()}
             for part, tmap in block_target_shapes(
                 self._cfg, self._cfg.layer_entry(i)).items()}
            for i in range(self._cfg.n_layers)]}

    def _template(self, rank: int):
        """(path, shape) of every leaf of a client tree at ``rank``."""
        tree = {"layers": [
            {part: {t: {"a": torch.empty((din, rank), device="meta"),
                        "b": torch.empty((rank, dout), device="meta")}
                    for t, (din, dout) in tmap.items()}
             for part, tmap in block_target_shapes(
                 self._cfg, self._cfg.layer_entry(i)).items()}
            for i in range(self._cfg.n_layers)]}
        return [(p, tuple(leaf.shape)) for p, leaf in tree_leaves(tree)]

    # ---- bookkeeping ------------------------------------------------------
    def __contains__(self, client_id) -> bool:
        return client_id in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def resident(self) -> List[Any]:
        """Client ids, least- to most-recently used."""
        return list(self._lru)

    def bucket_of_slot(self, slot: int) -> Tuple[int, int]:
        """Global slot id -> (bucket index, local slot within the bucket)."""
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        for b in reversed(range(len(self.bucket_offsets))):
            if slot >= self.bucket_offsets[b]:
                return b, slot - self.bucket_offsets[b]
        raise AssertionError("unreachable")

    def slot_ranks(self) -> np.ndarray:
        """(capacity,) int32: the native registered rank per slot (bucket
        rank for free slots)."""
        out = np.zeros(self.capacity, np.int32)
        for off, rb, sz in zip(self.bucket_offsets, self.bucket_ranks,
                               self.bucket_sizes):
            out[off:off + sz] = rb
        for cid, slot in self._lru.items():
            out[slot] = self._client_rank.get(cid, out[slot])
        return out

    def _bucket_for(self, rank: int) -> int:
        """Smallest bucket whose rank covers ``rank``."""
        for b, rb in enumerate(self.bucket_ranks):
            if rank <= rb:
                return b
        raise ValueError(
            f"adapter rank {rank} exceeds the largest rank bucket "
            f"(buckets: {self.bucket_ranks})")

    @staticmethod
    def _infer_rank(adapters: Params, what: str = "adapters") -> int:
        """The single LoRA rank of a client tree; rejects mixed ranks within
        one tree, naming the offending leaves."""
        found: Dict[int, str] = {}

        def walk(node, path):
            if _is_pair(node):
                found.setdefault(int(node["a"].shape[-1]), path or "<root>")
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}[{k!r}]")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{path}[{i}]")
        walk(adapters, "")
        if not found:
            raise ValueError(f"{what} tree has no {{'a', 'b'}} adapter pairs")
        if len(found) > 1:
            detail = ", ".join(f"rank {r} at {p}"
                               for r, p in sorted(found.items()))
            raise ValueError(
                f"{what} tree mixes LoRA ranks within one client: {detail}")
        return next(iter(found))

    def _grab_slot(self, client_id, bucket: int) -> int:
        if client_id in self._lru:
            slot = self._lru[client_id]
            b_cur, local = self.bucket_of_slot(slot)
            if b_cur == bucket:
                return slot
            # the client's rank moved buckets: its old slot returns to its
            # bucket's free list (a move is not an eviction)
            self._lru.pop(client_id)
            self._free[b_cur].append(local)
        if self._free[bucket]:
            return self.bucket_offsets[bucket] + self._free[bucket].pop(0)
        # evict the least-recently-used client resident in THIS bucket
        for evicted, slot in self._lru.items():      # LRU -> MRU order
            if self.bucket_of_slot(slot)[0] != bucket:
                continue
            self._lru.pop(evicted)
            # versions stay: monotonicity keeps stale prefix-cache entries
            # unreachable if the client comes back
            self._default_priority.pop(evicted, None)
            self._client_rank.pop(evicted, None)
            self.evictions += 1
            return slot
        raise AssertionError("bucket has neither free nor resident slots")

    def _validate_tree(self, adapters: Params, what: str = "adapters",
                       rank: Optional[int] = None):
        """Check ``adapters`` against the bank layout at ``rank`` (the
        largest bucket's by default) BEFORE any write, naming the first
        leaf that does not fit; returns its leaves in order."""
        template = self._template(self.bucket_ranks[-1] if rank is None
                                  else rank)
        leaves = tree_leaves(adapters)
        got = {p for p, _ in leaves}
        want = {p for p, _ in template}
        if got != want:
            missing, extra = sorted(want - got), sorted(got - want)
            raise ValueError(
                f"{what} tree structure does not match the adapter bank "
                f"template" + (f"; missing leaves: {missing}" if missing
                               else "")
                + (f"; unexpected leaves: {extra}" if extra else ""))
        for (path, shape), (_, leaf) in zip(template, leaves):
            if tuple(leaf.shape) != shape:
                raise ValueError(
                    f"{what} leaf {path} has shape {tuple(leaf.shape)}; the "
                    f"bank template expects {shape}")
        return [leaf for _, leaf in leaves]

    def _check_in(self, adapters: Params,
                  what: str = "adapters") -> Tuple[int, int]:
        """Validate an incoming tree and pick its bucket -> (rank, bucket)."""
        if self.ragged:
            rank = self._infer_rank(adapters, what=what)
            self._validate_tree(adapters, what=what, rank=rank)
            return rank, self._bucket_for(rank)
        self._validate_tree(adapters, what=what)
        return self.bucket_ranks[0], 0

    def _write_slot(self, bucket: int, local: int, adapters: Params) -> None:
        """Copy one client's fp32 tree into a bucket slot, zero-padding the
        rank axis up to the bucket rank and quantizing per (layer, client)
        and factor for an int8 bank."""
        rb = self.bucket_ranks[bucket]
        dst = {(i, part, t): node
               for i, part, t, node in _targets(self._banks[bucket])}
        for i, part, t, node in _targets(adapters):
            slot = dst[(i, part, t)]
            a = torch.as_tensor(node["a"], dtype=torch.float32,
                                device=self.device)
            b = torch.as_tensor(node["b"], dtype=torch.float32,
                                device=self.device)
            r = a.shape[-1]
            if r != rb:
                a = torch.nn.functional.pad(a, (0, rb - r))
                b = torch.nn.functional.pad(b, (0, 0, 0, rb - r))
            if self.bank_dtype == "int8":
                a, sa = quantize_int8(a, dim=(0, 1))
                b, sb = quantize_int8(b, dim=(0, 1))
                slot["a_scale"][local] = sa
                slot["b_scale"][local] = sb
            slot["a"][local].copy_(a)
            slot["b"][local].copy_(b)

    # ---- writes -----------------------------------------------------------
    def register(self, client_id, adapters: Params,
                 default_priority: Optional[str] = None) -> int:
        """Install (or refresh) a client's adapter tree (per-layer ``{"a",
        "b"}`` leaves as tensors or numpy arrays); returns its slot.
        ``default_priority`` names the SLA class for the client's requests
        that set none; ``None`` keeps any earlier default."""
        rank, bucket = self._check_in(adapters)
        if default_priority is not None:
            if default_priority not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown default_priority {default_priority!r} "
                    f"(have {sorted(PRIORITY_CLASSES)})")
            self._default_priority[client_id] = default_priority
        slot = self._grab_slot(client_id, bucket)
        self._write_slot(bucket, self.bucket_of_slot(slot)[1], adapters)
        self._lru[client_id] = slot
        self._lru.move_to_end(client_id)
        self._versions[client_id] = self._versions.get(client_id, 0) + 1
        self._client_rank[client_id] = rank
        self.bank_epoch += 1
        return slot

    def register_dual(self, client_id, personalized: Params, global_: Params,
                      fusion_weights,
                      default_priority: Optional[str] = None) -> int:
        """Fuse a dual-LoRA state by Eq. 7 and install the result."""
        check_rank_agreement(personalized, global_)
        rank, _ = self._check_in(personalized, what="personalized adapters")
        self._validate_tree(global_, what="global adapters",
                            rank=rank if self.ragged else None)
        fused = merge(personalized, global_, fusion_weights)
        return self.register(client_id, fused,
                             default_priority=default_priority)

    def evict(self, client_id) -> None:
        """Drop a client; its slot returns to its bucket's free list."""
        if client_id not in self._lru:
            raise KeyError(f"client {client_id!r} is not resident "
                           f"(resident: {self.resident})")
        bucket, local = self.bucket_of_slot(self._lru.pop(client_id))
        self._default_priority.pop(client_id, None)
        self._client_rank.pop(client_id, None)
        self._free[bucket].append(local)

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
        """The stacked adapter tree: per layer, leaves (C, d_in, r) / (C, r,
        d_out) (int8 banks add (C,) fp32 ``a_scale``/``b_scale``).  With
        several rank buckets each leaf is a per-bucket LIST, in global-slot
        order."""
        return self._bank

    def kernel_bank(self) -> Params:
        """The bank as the batched kernel reads it.  One bucket: the bank
        itself.  Ragged: per target the buckets concatenated on the client
        axis at the largest bucket rank (small buckets zero-padded) plus
        ``ranks`` (C,) int32, each slot's bucket rank, which the kernel's
        rank mask reads.  Built once per ``bank_epoch``."""
        if not self.ragged:
            return self._bank
        if self._kernel_bank is not None and \
                self._kernel_bank[0] == self.bank_epoch:
            return self._kernel_bank[1]
        view = {"layers": [{part: {t: concat_buckets(node)
                                   for t, node in tmap.items()}
                            for part, tmap in layer.items()}
                           for layer in self._bank["layers"]]}
        self._kernel_bank = (self.bank_epoch, view)
        return view

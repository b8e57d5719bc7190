"""Sharded serving: partitioned block pools, adapter banks and placement.

Port of ``repro/serving/sharded.py``.  Shards here are placement domains
on one card: the three stateful serving structures are split across
``num_shards`` shards while each engine round stays ONE fused dispatch
(request slots of all shards side by side in one batch).

* :class:`ShardedPagedKVCache` — ``num_shards`` independent
  :class:`~repro_torch.serving.kv_cache.PagedKVCache` allocators, each with
  its own free list, block tables, seal chains and prefix index over a
  disjoint slice of one global device block pool.  Shard ``s`` owns global
  blocks ``[1 + s*P, 1 + (s+1)*P)`` (``P`` allocatable blocks per shard);
  block 0 stays the one global scratch target.  ``device_tables`` shifts
  each shard's local table into global ids and concatenates, so the model's
  paged steps are untouched.  ``check_invariants`` holds per shard.

* :class:`ShardedAdapterRegistry` — ``num_shards`` fixed-capacity
  :class:`~repro_torch.serving.registry.AdapterRegistry` banks
  (``capacity / num_shards`` clients each).  A client is homed on one shard
  (fewest resident clients at first registration); :meth:`bank`
  concatenates the per-shard banks per rank bucket on the client axis, so
  global slots order as [bucket 0: shard 0..N, bucket 1: shard 0..N, ...]
  (:meth:`_global_slot`), and :meth:`kernel_bank` is the batched kernel's
  view of that global order.

* :class:`ShardedScheduler` — a placement-aware coordinator over
  ``num_shards`` unmodified :class:`~repro_torch.serving.scheduler.
  Scheduler` instances.  ``submit`` routes each request to the shard that
  holds its longest cached prefix, else its client's adapter home, else the
  least-loaded shard; preemption stays within a shard.  Each round the
  coordinator negotiates one global round kind (any shard prefilling ->
  prefill; else any shard with drafts -> verify; else decode at the min
  step count), forces it through every shard's ``prepare_chunk``,
  concatenates the per-shard host arrays into one dispatch and slices the
  observations back.  It duck-types the single ``Scheduler`` interface the
  engine drives.

Everything here is host bookkeeping: one device program per round, one
block pool, one adapter bank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dual_lora import check_rank_agreement, merge
from repro_torch.kernels.ops import concat_buckets
from repro_torch.serving.kv_cache import PagedKVCache, to_device
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.scheduler import Scheduler

Params = Any


class ShardedPagedKVCache:
    """``num_shards`` disjoint :class:`PagedKVCache` partitions of one pool.

    ``num_slots`` and ``num_blocks`` are GLOBAL (``num_blocks`` includes the
    shared scratch block 0); ``num_slots`` and ``num_blocks - 1`` must both
    divide evenly into ``num_shards``.  Global slot ``s * slots_per_shard +
    i`` is shard ``s``'s local slot ``i``; global block ``b`` (> 0) of shard
    ``s`` is local block ``b - s * blocks_per_shard``.
    """

    def __init__(self, num_shards: int, num_slots: int, block_size: int,
                 num_blocks: int, max_blocks_per_slot: int,
                 prefix_cache: bool = False):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_slots % num_shards != 0:
            raise ValueError(
                f"num_slots {num_slots} not divisible by {num_shards} shards")
        if (num_blocks - 1) % num_shards != 0:
            raise ValueError(
                f"allocatable blocks {num_blocks - 1} not divisible by "
                f"{num_shards} shards")
        self.num_shards = num_shards
        self.num_slots = num_slots
        self.slots_per_shard = num_slots // num_shards
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.blocks_per_shard = (num_blocks - 1) // num_shards
        self.max_blocks_per_slot = max_blocks_per_slot
        self.prefix_cache = prefix_cache
        self.shards: List[PagedKVCache] = [
            PagedKVCache(self.slots_per_shard, block_size,
                         1 + self.blocks_per_shard, max_blocks_per_slot,
                         prefix_cache=prefix_cache)
            for _ in range(num_shards)]

    # ---- slot translation --------------------------------------------------
    def shard_of_slot(self, slot: int) -> Tuple[int, int]:
        """Global slot -> (shard, local slot)."""
        return divmod(slot, self.slots_per_shard)

    def global_slot(self, shard: int, local: int) -> int:
        return shard * self.slots_per_shard + local

    # ---- aggregates --------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return sum(sh.free_blocks for sh in self.shards)

    @property
    def cached_blocks(self) -> int:
        return sum(sh.cached_blocks for sh in self.shards)

    @property
    def allocatable_blocks(self) -> int:
        return sum(sh.allocatable_blocks for sh in self.shards)

    @property
    def evicted_cached(self) -> int:
        return sum(sh.evicted_cached for sh in self.shards)

    @property
    def table_version(self) -> int:
        """Sum of the shards' monotone table counters: it moves whenever
        any shard's tables change, so the session keys its cached device
        tables on it as in the single-pool case."""
        return sum(sh.table_version for sh in self.shards)

    @property
    def lengths(self) -> np.ndarray:
        """Global per-slot context lengths (a concatenated snapshot)."""
        return np.concatenate([sh.lengths for sh in self.shards])

    @property
    def idle(self) -> bool:
        return all(sh.idle for sh in self.shards)

    def fits(self, n_tokens: int) -> bool:
        """Shards share one geometry: fits on one == fits on any."""
        return self.shards[0].fits(n_tokens)

    # ---- placement probe ---------------------------------------------------
    def best_prefix_shard(self, scope: Any, tokens: Sequence[int]
                          ) -> Tuple[Optional[int], int]:
        """``(shard, hit tokens)`` of the shard holding the longest cached
        prefix of ``tokens`` under ``scope``; ``(None, 0)`` when none does
        (or prefix caching is off)."""
        best, best_hit = None, 0
        for s, sh in enumerate(self.shards):
            hit = len(sh.match_prefix(scope, tokens)[0]) * self.block_size
            if hit > best_hit:
                best, best_hit = s, hit
        return best, best_hit

    # ---- device view -------------------------------------------------------
    def device_tables(self, device, shards: Optional[range] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global ``(block_tables, lengths)`` on ``device``, as snapshots
        that never wait for the stream (:func:`to_device`): each shard's
        local block ids shift into its global slice (block 0 stays 0).
        With ``shards`` (a range of shard indices: one data rank's, under
        ``ServeConfig.mesh``) the rows of those shards' slots only, their
        ids shifted into a pool that holds scratch block 0 and those
        shards' blocks, in order."""
        shards = range(self.num_shards) if shards is None else shards
        P = self.blocks_per_shard
        tables = np.concatenate(
            [np.where(self.shards[s].block_tables > 0,
                      self.shards[s].block_tables + (s - shards[0]) * P, 0)
             for s in shards], axis=0).astype(np.int32)
        lengths = np.concatenate([self.shards[s].lengths for s in shards])
        return to_device(tables, device), to_device(lengths, device)

    # ---- invariants --------------------------------------------------------
    def check_invariants(self) -> None:
        """Per-shard allocator invariants plus disjointness: every global
        block a shard's table names lies in that shard's slice."""
        for s, sh in enumerate(self.shards):
            sh.check_invariants()
            lo = 1 + s * self.blocks_per_shard
            hi = lo + self.blocks_per_shard
            t = sh.block_tables
            used = np.where(t > 0, t + s * self.blocks_per_shard, 0)
            bad = used[(used != 0) & ((used < lo) | (used >= hi))]
            assert bad.size == 0, \
                f"shard {s} references blocks outside [{lo}, {hi}): {bad}"


def _concat_trees(trees: Sequence[Params]) -> Params:
    """Leaf-wise concatenation on the client axis (axis 0) of trees of one
    structure; per-bucket list leaves concatenate bucket by bucket."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _concat_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list) and not torch.is_tensor(first[0]):
        return [_concat_trees([t[i] for t in trees])
                for i in range(len(first))]
    if isinstance(first, list):                  # per-bucket leaves
        return [torch.cat([t[i] for t in trees]) for i in range(len(first))]
    return torch.cat(list(trees))


class ShardedAdapterRegistry:
    """``num_shards`` fixed-capacity adapter banks behind one interface.

    A client is homed on one shard at first registration (fewest resident
    clients, lowest index on ties) and stays there until evicted; the
    scheduler reads :meth:`shard_of` to co-locate its requests with its
    adapter.  Every shard carries the same rank-bucket layout, and global
    slots order as [bucket 0: shard 0..N, bucket 1: shard 0..N, ...]
    (:meth:`_global_slot`), which :meth:`bank` (per-bucket concatenation on
    the client axis) and :meth:`kernel_bank` both follow.  Both are built
    once per ``bank_epoch``: a registration writes the shard's bank in
    place and the next snapshot is a new tensor, so a snapshot held by a
    dispatched chunk stays valid."""

    def __init__(self, cfg, capacity: int, num_shards: int,
                 rank: Optional[int] = None, bank_dtype: str = "f32",
                 ranks: Optional[Sequence[int]] = None, device="cuda"):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if capacity % num_shards != 0:
            raise ValueError(
                f"capacity {capacity} not divisible by {num_shards} shards")
        self.capacity = capacity
        self.num_shards = num_shards
        self.capacity_per_shard = capacity // num_shards
        self.bank_dtype = bank_dtype
        self.shards: List[AdapterRegistry] = [
            AdapterRegistry(cfg, self.capacity_per_shard, rank,
                            bank_dtype=bank_dtype, ranks=ranks, device=device)
            for _ in range(num_shards)]
        self.device = self.shards[0].device
        self._cfg = cfg
        self._home: Dict[Any, int] = {}
        self._versions: Dict[Any, int] = {}   # survives cross-shard moves
        self._bank: Optional[Tuple[int, Params]] = None
        self._kernel_bank: Optional[Tuple[int, Params]] = None

    # ---- bookkeeping ------------------------------------------------------
    def __contains__(self, client_id) -> bool:
        return client_id in self._home

    def __len__(self) -> int:
        return len(self._home)

    @property
    def resident(self) -> List[Any]:
        """Client ids grouped by shard (shard-major, LRU order within)."""
        return [cid for sh in self.shards for cid in sh.resident]

    @property
    def evictions(self) -> int:
        return sum(sh.evictions for sh in self.shards)

    def shard_of(self, client_id) -> Optional[int]:
        """The client's home shard, or None when it is not resident."""
        return self._home.get(client_id)

    @property
    def ragged(self) -> bool:
        return self.shards[0].ragged

    @property
    def bucket_ranks(self) -> List[int]:
        return self.shards[0].bucket_ranks

    @property
    def bank_epoch(self) -> int:
        """Monotone bank-content counter (sum over shards): the serving
        session's hot-swap signal, as for the single registry."""
        return sum(sh.bank_epoch for sh in self.shards)

    def _global_slot(self, s: int, local_slot: int) -> int:
        """Shard ``s``'s slot -> global slot under the per-bucket order of
        :meth:`bank`.  With one bucket: ``s * capacity_per_shard + local``."""
        sub = self.shards[s]
        b, loc = sub.bucket_of_slot(local_slot)
        off = self.num_shards * sum(sub.bucket_sizes[:b])
        return off + s * sub.bucket_sizes[b] + loc

    def slot_ranks(self) -> np.ndarray:
        """(capacity,) int32 native rank per GLOBAL slot (bucket rank for
        free slots; see ``AdapterRegistry.slot_ranks``)."""
        out = np.zeros(self.capacity, np.int32)
        for s, sh in enumerate(self.shards):
            sub = sh.slot_ranks()
            for local in range(sh.capacity):
                out[self._global_slot(s, local)] = sub[local]
        return out

    def _place(self, client_id) -> int:
        if client_id in self._home:
            return self._home[client_id]
        return min(range(self.num_shards),
                   key=lambda s: (len(self.shards[s]), s))

    # ---- writes -----------------------------------------------------------
    def register(self, client_id, adapters: Params,
                 default_priority: Optional[str] = None) -> int:
        """Install on the client's home shard (assigned now if new); returns
        the GLOBAL bank slot.  A full shard evicts its own LRU client."""
        s = self._place(client_id)
        sub = self.shards[s]
        before = set(sub.resident)
        local = sub.register(client_id, adapters,
                             default_priority=default_priority)
        for evicted in before - set(sub.resident) - {client_id}:
            self._home.pop(evicted, None)
        self._home[client_id] = s
        # the version lives at this level: per-shard counters restart when a
        # client is re-placed on another shard, which would resurrect stale
        # prefix-cache scopes
        self._versions[client_id] = self._versions.get(client_id, 0) + 1
        return self._global_slot(s, local)

    def register_dual(self, client_id, personalized: Params, global_: Params,
                      fusion_weights,
                      default_priority: Optional[str] = None) -> int:
        """Fuse a dual-LoRA state by Eq. 7 and install the result."""
        sub = self.shards[self._place(client_id)]
        check_rank_agreement(personalized, global_)
        rank, _ = sub._check_in(personalized, what="personalized adapters")
        sub._validate_tree(global_, what="global adapters",
                           rank=rank if sub.ragged else None)
        fused = merge(personalized, global_, fusion_weights)
        return self.register(client_id, fused,
                             default_priority=default_priority)

    def evict(self, client_id) -> None:
        if client_id not in self._home:
            raise KeyError(f"client {client_id!r} is not resident "
                           f"(resident: {self.resident})")
        self.shards[self._home.pop(client_id)].evict(client_id)

    # ---- reads ------------------------------------------------------------
    def acquire(self, client_id) -> int:
        s = self._home.get(client_id)
        if s is None:
            raise KeyError(f"client {client_id!r} is not resident "
                           f"(resident: {self.resident})")
        return self._global_slot(s, self.shards[s].acquire(client_id))

    def default_priority(self, client_id) -> Optional[str]:
        s = self._home.get(client_id)
        return None if s is None else self.shards[s].default_priority(client_id)

    def version(self, client_id) -> int:
        """Monotone per-client weight version (prefix-cache scope), kept at
        the sharded level so it survives cross-shard re-registration;
        raises ``KeyError`` for a client that was never registered."""
        if client_id not in self._versions:
            raise KeyError(f"client {client_id!r} was never registered "
                           f"(resident: {self.resident})")
        return self._versions[client_id]

    def bank(self) -> Params:
        """The global bank: the shards' banks concatenated on the client
        axis (leaves (capacity, d_in, r)); ragged banks per bucket (list
        leaves), matching :meth:`_global_slot`."""
        epoch = self.bank_epoch
        if self._bank is None or self._bank[0] != epoch:
            self._bank = (epoch, _concat_trees([sh.bank()
                                                for sh in self.shards]))
        return self._bank[1]

    def kernel_bank(self) -> Params:
        """The global bank as the batched kernel reads it.  One bucket: the
        bank itself.  Ragged: per target the global buckets concatenated
        at the largest bucket rank (small buckets zero-padded), int8 scales
        in the same order, and ``ranks`` (capacity,) int32 from
        :meth:`slot_ranks`, the kernel's rank mask, in global slot order.
        Built from :meth:`bank`, so the slot order is the global one (not
        each shard's own view side by side)."""
        bank = self.bank()
        if not self.ragged:
            return bank
        epoch = self.bank_epoch
        if self._kernel_bank is not None and self._kernel_bank[0] == epoch:
            return self._kernel_bank[1]
        ranks = to_device(self.slot_ranks(), self.device)
        view = {"layers": [
            {part: {t: {**concat_buckets(node), "ranks": ranks}
                    for t, node in tmap.items()}
             for part, tmap in layer.items()}
            for layer in bank["layers"]]}
        self._kernel_bank = (epoch, view)
        return view


class ShardedScheduler:
    """Placement-aware coordinator over per-shard :class:`Scheduler`\\ s.

    Duck-types the single ``Scheduler``'s driving interface (submit / admit
    / prepare_chunk / *_arrays / observe_* / counters) over the GLOBAL slot
    axis, so :class:`~repro_torch.serving.engine.StreamSession` drives
    either.  ``registry`` (optional) gives ``shard_of`` for adapter
    placement; without it placement is by prefix and load only."""

    def __init__(self, kv: ShardedPagedKVCache, registry: Any = None,
                 policy: str = "sla", aging_ticks: int = 16,
                 victim_policy: Optional[Callable] = None,
                 spec_k: int = 0, spec_ngram: int = 3):
        self.kv = kv
        self.registry = registry
        self.shards: List[Scheduler] = [
            Scheduler(pool, policy=policy, aging_ticks=aging_ticks,
                      victim_policy=victim_policy, spec_k=spec_k,
                      spec_ngram=spec_ngram)
            for pool in kv.shards]
        self.policy = policy
        self.spec_k = spec_k
        self.placements: Dict[int, int] = {}        # rid -> shard
        self.placed = {"prefix": 0, "adapter": 0, "load": 0}

    # ---- placement --------------------------------------------------------
    def _load(self, s: int) -> int:
        sh = self.shards[s]
        return len(sh.active_slots) + len(sh._queue)

    def place(self, client_id, scope: Any, prompt) -> Tuple[int, str]:
        """The shard for a new request and why: ``"prefix"`` (a shard holds
        a cached prefix of the prompt), ``"adapter"`` (the client's adapter
        home) or ``"load"`` (fewest active + queued requests, then most
        allocatable blocks, then lowest index)."""
        shard, hit = self.kv.best_prefix_shard(scope, prompt)
        if shard is not None and hit > 0:
            return shard, "prefix"
        shard_of = getattr(self.registry, "shard_of", None)
        if shard_of is not None:
            shard = shard_of(client_id)
            if shard is not None:
                return shard, "adapter"
        shard = min(range(len(self.shards)),
                    key=lambda s: (self._load(s),
                                   -self.kv.shards[s].allocatable_blocks, s))
        return shard, "load"

    # ---- intake -----------------------------------------------------------
    def submit(self, rid: int, client_id: Any, prompt, budget: int,
               scope: Any = None, priority: str = "batch",
               deadline: Optional[float] = None,
               arrival_time: Optional[float] = None) -> int:
        """Place and enqueue; returns the chosen shard."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        shard, why = self.place(client_id,
                                client_id if scope is None else scope,
                                prompt)
        self.shards[shard].submit(rid, client_id, prompt, budget,
                                  scope=scope, priority=priority,
                                  deadline=deadline,
                                  arrival_time=arrival_time)
        self.placements[rid] = shard
        self.placed[why] += 1
        return shard

    # ---- state ------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return any(sh.has_work for sh in self.shards)

    @property
    def active_slots(self) -> List[int]:
        return [self.kv.global_slot(s, slot)
                for s, sh in enumerate(self.shards)
                for slot in sh.active_slots]

    @property
    def prefill_pending(self) -> bool:
        return any(sh.prefill_pending for sh in self.shards)

    @property
    def results(self) -> Dict[int, np.ndarray]:
        merged: Dict[int, np.ndarray] = {}
        for sh in self.shards:
            merged.update(sh.results)
        return merged

    # ---- lifecycle --------------------------------------------------------
    def admit(self) -> List[Tuple[int, Any]]:
        """Per-shard admission; returns GLOBAL (slot, client_id) pairs."""
        return [(self.kv.global_slot(s, slot), cid)
                for s, sh in enumerate(self.shards)
                for slot, cid in sh.admit()]

    def negotiate_round(self, decode_cap: int):
        """One global round kind (a fused dispatch has one shape): any
        shard prefilling -> prefill (the others ride as 1-token feedback
        rows); else any shard with drafts -> verify; else decode at the min
        of the shards' planned steps, so no slot overshoots its budget.
        None when no shard has an active slot."""
        prefs = [p for p in (sh.preferred_round(decode_cap)
                             for sh in self.shards) if p is not None]
        if not prefs:
            return None
        if any(p[0] == "prefill" for p in prefs):
            return ("prefill", None)
        if any(p[0] == "verify" for p in prefs):
            return ("verify", None)
        return ("decode", min(p[1] for p in prefs))

    def prepare_chunk(self, prefill_chunk: int, decode_cap: int):
        """Negotiate the round and force it through every shard's planner
        (growth and within-shard preemption happen there).  Returns the
        global plan, shaped as ``Scheduler.prepare_chunk``'s."""
        plan = self.negotiate_round(decode_cap)
        if plan is None:
            return None
        kind, steps = plan
        for sh in self.shards:
            sh.prepare_chunk(prefill_chunk, decode_cap, kind=kind,
                             steps=steps)
        return plan

    # ---- fused host arrays -------------------------------------------------
    @staticmethod
    def _concat(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}

    def prefill_arrays(self, width: int):
        return self._concat([sh.prefill_arrays(width) for sh in self.shards])

    def verify_arrays(self, width: int):
        return self._concat([sh.verify_arrays(width) for sh in self.shards])

    def chunk_arrays(self):
        return self._concat([sh.chunk_arrays() for sh in self.shards])

    def _rows(self, s: int) -> slice:
        K = self.kv.slots_per_shard
        return slice(s * K, (s + 1) * K)

    def chunk_emits(self, n_new) -> bool:
        """Any shard emitting makes the fused chunk an emitting one."""
        return any(sh.chunk_emits(n_new[self._rows(s)])
                   for s, sh in enumerate(self.shards))

    def observe_prefill(self, n_new, sampled, eos_id=None):
        """``sampled`` is None for a chunk that emits nothing (never read
        back): then no shard emits, and each shard gets None too."""
        events = []
        for s, sh in enumerate(self.shards):
            r = self._rows(s)
            events.extend(sh.observe_prefill(
                n_new[r], None if sampled is None else sampled[r],
                eos_id=eos_id))
        return events

    def observe_verify(self, n_new, greedy, eos_id=None):
        events = []
        for s, sh in enumerate(self.shards):
            r = self._rows(s)
            events.extend(sh.observe_verify(n_new[r], greedy[r],
                                            eos_id=eos_id))
        return events

    def observe_chunk(self, sampled, eos_id=None):
        events = []
        for s, sh in enumerate(self.shards):
            events.extend(sh.observe_chunk(sampled[:, self._rows(s)],
                                           eos_id=eos_id))
        return events

    # ---- stats (aggregated as the single Scheduler's counters) -------------
    # Every shard observes every fused dispatch, so dispatch counters are
    # the max (each shard's count), not the sum; token and preemption
    # counters are per-request work and sum.
    @property
    def prefill_dispatches(self) -> int:
        return max(sh.prefill_dispatches for sh in self.shards)

    @property
    def decode_dispatches(self) -> int:
        return max(sh.decode_dispatches for sh in self.shards)

    @property
    def verify_dispatches(self) -> int:
        return max(sh.verify_dispatches for sh in self.shards)

    @property
    def steps(self) -> int:
        return max(sh.steps for sh in self.shards)

    @property
    def ticks(self) -> int:
        return max(sh.ticks for sh in self.shards)

    @property
    def drafted_tokens(self) -> int:
        return sum(sh.drafted_tokens for sh in self.shards)

    @property
    def accepted_tokens(self) -> int:
        return sum(sh.accepted_tokens for sh in self.shards)

    @property
    def rollback_tokens(self) -> int:
        return sum(sh.rollback_tokens for sh in self.shards)

    @property
    def rollback_blocks(self) -> int:
        return sum(sh.rollback_blocks for sh in self.shards)

    @property
    def preemptions(self) -> int:
        return sum(sh.preemptions for sh in self.shards)

    @property
    def prompt_tokens(self) -> int:
        return sum(sh.prompt_tokens for sh in self.shards)

    @property
    def prefix_hit_tokens(self) -> int:
        return sum(sh.prefix_hit_tokens for sh in self.shards)

    @property
    def preemptions_by_class(self) -> Dict[str, int]:
        merged: Dict[str, int] = {}
        for sh in self.shards:
            for k, v in sh.preemptions_by_class.items():
                merged[k] = merged.get(k, 0) + v
        return merged

    @property
    def victim_sealed_fractions(self) -> List[float]:
        return [f for sh in self.shards for f in sh.victim_sealed_fractions]

    @property
    def wait_ticks(self) -> Dict[str, List[int]]:
        merged: Dict[str, List[int]] = {}
        for sh in self.shards:
            for k, v in sh.wait_ticks.items():
                merged.setdefault(k, []).extend(v)
        return merged

    @property
    def wait_wall(self) -> Dict[str, List[float]]:
        merged: Dict[str, List[float]] = {}
        for sh in self.shards:
            for k, v in sh.wait_wall.items():
                merged.setdefault(k, []).extend(v)
        return merged

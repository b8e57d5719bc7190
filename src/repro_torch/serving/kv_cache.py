"""Paged KV cache: a content-addressed, refcounted block pool.

The serving path replaces the monolithic per-batch ``(B, cache_len)`` cache
tree (``models/model.py::init_decode_cache``) with fixed-size K/V *blocks*
drawn from one pool per attention layer
(``models/model.py::init_paged_decode_cache``).  Each serving **slot** (a
row of the decode batch) owns a *block table* — a row of physical block ids
— plus a context length; attention gathers through the table, so slots with
ragged lengths share one pool with zero padding waste in HBM.  SSM/Mamba
layers have O(1) recurrent state and simply keep a dense per-slot row
(reset on admission via :func:`reset_slot`).

Blocks are allocated **on demand** (vLLM style): admission claims a slot
with zero blocks, and the scheduler calls :meth:`PagedKVCache.ensure`
before each device chunk to grow every active slot's table to cover the
positions the chunk will write.  A failed ``ensure`` (nothing allocatable)
is the scheduler's preemption trigger — it releases a victim's blocks and
requeues the victim with its prompt+emitted tokens as the new prompt, so
the pool admits far deeper queues than full-span reservation while no work
is ever lost.

**Prefix caching** (``prefix_cache=True``) turns the pool content-addressed
and refcounted: every *sealed* block (a block the owning slot has written
full) gets a chain digest of ``(parent digest, block's token ids)`` rooted
at the slot's *scope* (the engine uses ``(client_id, adapter version)`` —
K/V depends on the adapter, so blocks never leak across clients or across
re-registered weights).  A ``digest -> block`` index lets :meth:`admit`
match the longest cached prefix of a new prompt and map those blocks into
the slot's table with ``refcount += 1`` — their prefill is skipped entirely
(the scheduler starts ``fed`` past the hit).  The match is capped at
``len(prompt) - 1`` tokens so at least one prompt token is always prefilled
(the first sampled logit needs a live forward pass).

Refcount lifecycle: a fresh block is private (``refcount == 1``) and is the
ONLY kind of block ever written — the tail a slot is still filling is
private until sealed, and sealed blocks are full, so sharing needs no
copy-on-write.  :meth:`release` (finish or preemption) decrements; at zero
an *indexed* block parks in an LRU cached-free pool — its device content
intact, ready to be re-matched (a preempted request re-admitted with
``prompt + emitted`` re-matches its own sealed blocks and resumes with
near-zero re-prefill) — while unindexed blocks return to the plain FIFO
free list.  Allocation prefers the free list and only then evicts the
least-recently-released cached block (dropping its index entry), so a warm
cache degrades gracefully under pool pressure and preemption's progress
bound is unchanged: everything cached-free is still allocatable.

This class is pure host bookkeeping: the device pools live in the model's
cache and are updated in place by the steps; the tables are uploaded per
chunk (a few hundred int32s).  Physical block 0 is reserved as a scratch
target so *inactive* slots (table rows all-zero, length 0) and ragged
prefill-chunk tails scatter their garbage writes somewhere harmless
instead of corrupting a live request's block — block 0 is never allocated,
never sealed, never shared.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A SNAPSHOT of host array ``arr`` on ``device`` that never waits for
    the stream.  On a card the values are copied into pinned memory owned by
    the copy (PyTorch's caching host allocator keeps the block until the
    copy has run) and sent with ``non_blocking=True``: a copy from pageable
    memory would wait for the stream to drain.  On the CPU a plain copy
    (``torch.from_numpy`` would alias ``arr``, which the host mutates in
    place while a dispatched chunk may still read the tensor)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def kv_bytes_per_block(block_size: int, n_kv_heads: int, head_dim: int,
                       kv_dtype: str = "f32") -> int:
    """Device bytes one K+V block pair costs per attention layer: bf16
    pools for ``"f32"``; for ``"int8"`` 1-byte values plus one fp32 scale
    per (position, kv-head) and factor."""
    positions = block_size * n_kv_heads
    if kv_dtype == "int8":
        return 2 * positions * (head_dim * 1 + 4)     # K+V values + scales
    if kv_dtype != "f32":
        raise ValueError(f"kv_dtype must be 'f32' or 'int8', got {kv_dtype!r}")
    return 2 * positions * head_dim * 2               # bf16 K+V


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return -(-max(n_tokens, 1) // block_size)


def _root_digest(scope: Any) -> bytes:
    return hashlib.sha256(b"scope:" + repr(scope).encode()).digest()


def _chain_digest(parent: bytes, tokens: Sequence[int]) -> bytes:
    data = np.asarray(tokens, np.int32).tobytes()
    return hashlib.sha256(parent + data).digest()


class PagedKVCache:
    """Block allocator + block tables for ``num_slots`` serving slots.

    ``num_blocks`` counts physical blocks *including* the reserved scratch
    block 0; ``max_blocks_per_slot`` fixes the block-table width (and so the
    longest admissible context: ``max_blocks_per_slot * block_size``).
    With ``prefix_cache=True`` sealed blocks are content-addressed and
    shared across slots/calls (see module docstring); refcounting is always
    on — without the flag every block simply stays at refcount 1.
    """

    def __init__(self, num_slots: int, block_size: int, num_blocks: int,
                 max_blocks_per_slot: int, prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_slots = num_slots
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks_per_slot = max_blocks_per_slot
        self.prefix_cache = prefix_cache
        self.block_tables = np.zeros((num_slots, max_blocks_per_slot),
                                     np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        # monotonic counter bumped on every block-table mutation (admit,
        # growth, rollback, release).  ``advance`` does NOT bump it: pure
        # length growth is exactly what the engine's overlap fast path
        # chains on device, so callers caching ``device_tables()`` output
        # can key their cache on this and skip re-marshalling tables on
        # advance-only rounds.
        self.table_version = 0
        self._free: "deque[int]" = deque(range(1, num_blocks))
        # refcount-0 blocks whose content is still indexed, least-recently
        # released first (the eviction end) — the AdapterRegistry LRU
        # discipline applied to blocks instead of adapters.
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._refcount = np.zeros((num_blocks,), np.int64)
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._occupied: List[bool] = [False] * num_slots
        # content addressing: digest -> block, plus per-block reverse maps
        # (kept ONLY for indexed blocks; cleared on eviction/reuse)
        self._index: dict = {}
        self._block_hash: dict = {}
        self._block_tokens: dict = {}
        # per-slot hashing state: scope, running chain digest (None = sealing
        # disabled for this slot), sealed-block count, unsealed tail tokens
        self._scope: List[Any] = [None] * num_slots
        self._chain: List[Optional[bytes]] = [None] * num_slots
        self._nseal: List[int] = [0] * num_slots
        self._pending: List[List[int]] = [[] for _ in range(num_slots)]
        # rollback support: the chain digest AFTER each sealed block
        # (element 0 = root, element i = digest after i seals) and the token
        # ids each seal consumed — :meth:`rollback` pops these to rewind the
        # chain and refill ``_pending`` when it unseals a block.  Maintained
        # only while the slot's chain is live (frozen once sealing is
        # disabled; the already-sealed prefix keeps its history).
        self._chain_stack: List[List[bytes]] = [[] for _ in range(num_slots)]
        self._seal_toks: List[List[tuple]] = [[] for _ in range(num_slots)]
        self.evicted_cached = 0    # pool-lifetime cached-block evictions

    # ---- capacity ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained for prefix re-matching (allocatable)."""
        return len(self._cached)

    @property
    def allocatable_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    def fits(self, n_tokens: int) -> bool:
        """Can a request spanning ``n_tokens`` EVER be admitted (even with
        every other slot preempted and the whole cache evicted)?"""
        n = blocks_needed(n_tokens, self.block_size)
        return n <= min(self.max_blocks_per_slot, self.num_blocks - 1)

    def can_admit(self, n_tokens: int) -> bool:
        """Are there allocatable blocks to cover ``n_tokens`` positions right
        now?  (An admission heuristic — blocks are NOT reserved until
        :meth:`ensure` allocates them chunk by chunk; cached-free blocks
        count because growth may evict them.)"""
        return (self.fits(n_tokens)
                and blocks_needed(n_tokens, self.block_size)
                <= self.allocatable_blocks)

    # ---- allocation -------------------------------------------------------
    def _drop_index(self, block: int) -> None:
        digest = self._block_hash.pop(block, None)
        if digest is not None:
            self._index.pop(digest, None)
        self._block_tokens.pop(block, None)

    def _alloc(self) -> int:
        """One fresh private block: free list first, else evict the
        least-recently-released cached block (its index entry dies with it)."""
        if self._free:
            return self._free.popleft()
        block, _ = self._cached.popitem(last=False)
        self._drop_index(block)
        self.evicted_cached += 1
        return block

    # ---- prefix matching --------------------------------------------------
    def match_prefix(self, scope: Any, tokens: Sequence[int]
                     ) -> Tuple[List[int], bytes]:
        """Longest cached prefix of ``tokens`` under ``scope``: walks full
        blocks, chaining digests, and stops at the first index miss.  The
        match is capped at ``len(tokens) - 1`` so at least one token is left
        to prefill.  Returns ``(blocks, chain digest after the match)``."""
        chain = _root_digest(scope)
        hits: List[int] = []
        if not self.prefix_cache:
            return hits, chain
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        full = (int(tokens.size) - 1) // self.block_size
        for i in range(min(full, self.max_blocks_per_slot)):
            blk_toks = tuple(int(t) for t in
                             tokens[i * self.block_size:
                                    (i + 1) * self.block_size])
            digest = _chain_digest(chain, blk_toks)
            block = self._index.get(digest)
            if block is None:
                break
            # serving a mismatched block would silently corrupt a request's
            # context — keep this live under ``python -O``
            if self._block_tokens[block] != blk_toks:
                raise RuntimeError(
                    f"prefix index corrupt: block {block}'s digest matches "
                    "different tokens than it stores")
            hits.append(block)
            chain = digest
        return hits, chain

    # ---- slot lifecycle ---------------------------------------------------
    def admit(self, slot: int, scope: Any = None,
              tokens: Optional[Sequence[int]] = None) -> int:
        """Claim ``slot`` with zero private blocks; :meth:`ensure` grows it.

        With prefix caching, ``tokens`` (the request's prompt) is matched
        against the cache under ``scope`` and every hit block is mapped
        into the slot's table with ``refcount += 1`` — the slot starts with
        ``lengths[slot]`` already covering the hit, and the scheduler skips
        prefilling those positions.  Returns the number of cached tokens
        (0 without a hit or with caching disabled)."""
        if self._occupied[slot]:
            raise ValueError(f"slot {slot} already occupied")
        self._occupied[slot] = True
        self.table_version += 1
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self._owned[slot] = []
        self._pending[slot] = []
        self._nseal[slot] = 0
        self._scope[slot] = scope
        self._chain[slot] = _root_digest(scope) if self.prefix_cache else None
        self._chain_stack[slot] = (
            [self._chain[slot]] if self.prefix_cache else [])
        self._seal_toks[slot] = []
        if self.prefix_cache and tokens is not None:
            hits, chain = self.match_prefix(scope, tokens)
            for i, block in enumerate(hits):
                self._refcount[block] += 1
                self._cached.pop(block, None)      # 0 -> 1: leaves the pool
                self.block_tables[slot, i] = block
                self._owned[slot].append(block)
                # hit blocks are canonical (the index maps to them), so the
                # reverse maps reconstruct their per-seal digests and tokens
                self._chain_stack[slot].append(self._block_hash[block])
                self._seal_toks[slot].append(self._block_tokens[block])
            self._nseal[slot] = len(hits)
            self._chain[slot] = chain
            self.lengths[slot] = len(hits) * self.block_size
        return int(self.lengths[slot])

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to own blocks covering ``n_tokens`` positions.

        Growth only ever appends fresh PRIVATE blocks (prefix hits happen at
        admission; every block past the sealed prefix is refcount-1, so the
        scatter path never writes shared content).  Returns False
        (allocating nothing) when free + cached-free blocks cannot cover
        the growth — the scheduler's cue to preempt a victim and retry."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} not occupied")
        need = blocks_needed(n_tokens, self.block_size)
        # a real exception, not an assert: this guards the block-table
        # bounds on the serving hot path and must survive ``python -O``
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot} needs {need} blocks for {n_tokens} tokens but "
                f"tables hold max_blocks_per_slot={self.max_blocks_per_slot} "
                "(admission should have rejected this request: see fits())")
        add = need - len(self._owned[slot])
        if add <= 0:
            return True
        if add > self.allocatable_blocks:
            return False
        self.table_version += 1
        for _ in range(add):
            b = self._alloc()
            self._refcount[b] = 1
            self.block_tables[slot, len(self._owned[slot])] = b
            self._owned[slot].append(b)
        return True

    def _seal(self, slot: int) -> None:
        """The oldest unsealed block of ``slot`` is now full: chain its
        digest and index it (first writer wins; duplicate content keeps the
        original block as the canonical copy)."""
        block = self._owned[slot][self._nseal[slot]]
        toks = tuple(self._pending[slot][:self.block_size])
        del self._pending[slot][:self.block_size]
        digest = _chain_digest(self._chain[slot], toks)
        self._chain[slot] = digest
        self._nseal[slot] += 1
        self._chain_stack[slot].append(digest)
        self._seal_toks[slot].append(toks)
        if digest not in self._index:
            self._index[digest] = block
            self._block_hash[block] = digest
            self._block_tokens[block] = toks

    def advance(self, slot: int, n: int = 1,
                tokens: Optional[Sequence[int]] = None) -> None:
        """``n`` tokens were written at positions ``lengths[slot]``...

        ``tokens`` (the written ids, length ``n``) feeds the sealing chain:
        each block the write fills becomes content-addressed and shareable.
        Passing ``tokens=None`` permanently disables sealing for this slot
        incarnation (unhashable writes must never be served as a prefix)."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} not occupied")
        new_len = int(self.lengths[slot]) + n
        if new_len > len(self._owned[slot]) * self.block_size:
            raise ValueError(
                f"slot {slot} advanced past its owned blocks "
                f"({new_len} > {len(self._owned[slot])} * {self.block_size})")
        self.lengths[slot] = new_len
        if self._chain[slot] is None:
            return
        if tokens is None:
            self._chain[slot] = None
            self._pending[slot] = []
            return
        if len(tokens) != n:
            raise ValueError(f"advance(n={n}) got {len(tokens)} tokens")
        self._pending[slot].extend(int(t) for t in tokens)
        while len(self._pending[slot]) >= self.block_size:
            self._seal(slot)

    def rollback(self, slot: int, n_tokens: int) -> int:
        """Truncate ``slot``'s context to its first ``n_tokens`` tokens —
        the speculative-decoding undo: a verify dispatch writes K/V for the
        whole drafted chunk optimistically, then rolls the slot back past
        the first greedy mismatch.

        Token-granular: reduces ``lengths``, truncates the unsealed pending
        tail, UN-seals any sealed block past the new length (dropping its
        index entry if this slot's block was the canonical copy, popping
        its digest off the chain so future seals re-chain from the right
        parent, and refilling ``_pending`` with the tokens of a partially
        rolled-back block), and frees now-unneeded tail blocks back to the
        pool.  Raises ``ValueError`` — before mutating anything — if a
        sealed block to be rolled back is co-owned (``refcount >= 2``):
        shared prefix content is live in another slot's table and must
        never be invalidated under it.  (The engine's verify path can't hit
        this: it only rolls back tokens advanced within the same observe
        round, before any admission could have matched them.)

        Returns the number of blocks freed back to the pool."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} not occupied")
        cur = int(self.lengths[slot])
        if not 0 <= n_tokens <= cur:
            raise ValueError(
                f"rollback target {n_tokens} outside [0, {cur}]")
        bs = self.block_size
        new_nseal = min(self._nseal[slot], n_tokens // bs)
        for i in range(new_nseal, self._nseal[slot]):
            b = self._owned[slot][i]
            if self._refcount[b] >= 2:
                raise ValueError(
                    f"rollback past sealed block {b} shared by another slot "
                    f"(refcount {int(self._refcount[b])}): co-owned prefix "
                    "content cannot be invalidated")
        while self._nseal[slot] > new_nseal:
            i = self._nseal[slot] - 1
            b = self._owned[slot][i]
            self._drop_index(b)                # no-op for duplicate content
            self._nseal[slot] = i
            if self._chain[slot] is not None:
                toks = self._seal_toks[slot].pop()
                self._chain_stack[slot].pop()
                self._chain[slot] = self._chain_stack[slot][-1]
                self._pending[slot][:0] = list(toks)
        if self._chain[slot] is not None:
            del self._pending[slot][n_tokens - new_nseal * bs:]
        keep = -(-n_tokens // bs)              # ceil; >= new_nseal always
        self.table_version += 1
        freed = 0
        while len(self._owned[slot]) > keep:
            b = self._owned[slot].pop()
            self.block_tables[slot, len(self._owned[slot])] = 0
            # pool-integrity guard (must survive ``python -O``): freeing a
            # co-owned block here would hand shared live content back to the
            # allocator.  The pre-scan above only covers SEALED blocks, so
            # this is the last line of defence for the unsealed tail.
            if self._refcount[b] != 1:
                raise RuntimeError(
                    f"rollback freeing tail block {b} with refcount "
                    f"{int(self._refcount[b])} (expected 1: unsealed tail "
                    "blocks are always private)")
            self._refcount[b] = 0              # unsealed + unindexed by now
            self._free.append(b)
            freed += 1
        self.lengths[slot] = n_tokens
        return freed

    def sealed_fraction(self, slot: int) -> float:
        """Fraction of ``slot``'s owned blocks that are sealed (content-
        addressed — matched at admission or filled and indexed since).
        On release these park re-matchable in the cached-free pool (until
        pool pressure evicts them).  0.0 for empty slots and for pools
        without ``prefix_cache``."""
        if not self._occupied[slot] or not self._owned[slot]:
            return 0.0
        return self._nseal[slot] / len(self._owned[slot])

    def sealed_tokens(self, slot: int) -> int:
        """Leading context tokens of ``slot`` living in SEALED blocks.
        On release these park content-addressed (cached-free LRU) and
        re-match at the request's re-admission — near-free preemption —
        unless pool pressure evicts them in between."""
        return self._nseal[slot] * self.block_size

    def shared_prefix_tokens(self, slot: int) -> int:
        """Tokens in ``slot``'s leading run of sealed blocks that are CO-
        OWNED by another slot (``refcount >= 2``).  These survive this
        slot's release for sure — the co-owner keeps them referenced, out
        of eviction's reach — so a preempted request re-matches at least
        this prefix at re-admission.  (Merely cached-parked blocks don't
        count: the pool pressure that forces a preemption is exactly what
        evicts them.)  The scheduler's SLA victim policy reads
        ``lengths[slot] - shared_prefix_tokens(slot)`` as the re-prefill
        cost of preempting this slot."""
        run = 0
        for i, b in enumerate(self._owned[slot]):
            if i >= self._nseal[slot] or self._refcount[b] < 2:
                break
            run += 1
        return run * self.block_size

    def owned_blocks(self, slot: int) -> int:
        """Blocks currently backing ``slot``'s table (shared hits included)."""
        return len(self._owned[slot])

    def releasable_blocks(self, slot: int) -> int:
        """How many of ``slot``'s blocks become ALLOCATABLE if it releases
        now — its refcount-1 blocks (freed or cached-parked, both
        allocatable).  Co-owned blocks (refcount >= 2) stay referenced and
        yield nothing; a preemption victim is only worth preempting for the
        blocks this counts."""
        return sum(1 for b in self._owned[slot] if self._refcount[b] == 1)

    def release(self, slot: int) -> None:
        """Drop a finished/preempted slot's references.  Blocks reaching
        refcount 0 park in the cached-free LRU if indexed (content retained
        for future prefix hits; deepest blocks are evicted first within one
        release), else return to the FIFO free list."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} not occupied (double release?)")
        owned = self._owned[slot]
        for b in owned:
            self._refcount[b] -= 1
        for b in owned:                       # FIFO free list, table order
            if self._refcount[b] == 0 and b not in self._block_hash:
                self._free.append(b)
        for b in reversed(owned):             # tail blocks evict first
            if self._refcount[b] == 0 and b in self._block_hash:
                self._cached[b] = None
        self._owned[slot] = []
        self._occupied[slot] = False
        self._pending[slot] = []
        self._nseal[slot] = 0
        self._chain[slot] = None
        self._chain_stack[slot] = []
        self._seal_toks[slot] = []
        self._scope[slot] = None
        self.table_version += 1
        self.block_tables[slot] = 0
        self.lengths[slot] = 0

    # ---- invariants -------------------------------------------------------
    def check_invariants(self) -> None:
        """Refcount conservation must hold after every scheduler transition:

        * every block's refcount equals the number of slot-table references
          to it (shared blocks may appear in several tables);
        * each of {1..num_blocks-1} is in exactly one state: referenced
          (refcount > 0, in no free pool), cached-free (refcount 0, indexed,
          content retained), or free (refcount 0, unindexed);
        * no shared or cached block is ever on the free list;
        * the index and per-block reverse maps agree;
        * tables name owned blocks in position order; lengths stay within
          the owned span AND the table's capacity; sealed+pending
          accounting matches lengths;
        * rollback bookkeeping is consistent: no freed block is referenced
          by any table row, and a live chain's per-seal digest/token
          history matches the sealed-block count exactly (so a future
          rollback can always rewind the chain).
        """
        refs = np.zeros((self.num_blocks,), np.int64)
        for blocks in self._owned:
            for b in blocks:
                refs[b] += 1
        assert (refs == self._refcount).all(), \
            "refcount conservation broken (sum of table refs != refcount)"
        free_list = list(self._free)
        free_set = set(free_list)
        assert len(free_set) == len(free_list), "free list duplicates"
        cached = set(self._cached)
        assert not (free_set & cached), "block both free and cached-free"
        for b in range(1, self.num_blocks):
            states = (int(refs[b] > 0) + int(b in cached)
                      + int(b in free_set))
            assert states == 1, \
                f"block {b} in {states} states (refs={refs[b]})"
        for b in free_list:
            assert b not in self._block_hash, \
                f"indexed block {b} on the plain free list"
        # rollback safety: a freed block must have vanished from every
        # table row (a stale reference would gather freed content)
        referenced = set(int(b) for row in self.block_tables
                         for b in row if b != 0)
        assert not (free_set & referenced), \
            f"freed blocks still in a table: {sorted(free_set & referenced)}"
        for b in cached:
            assert b in self._block_hash, f"cached-free block {b} unindexed"
        for digest, b in self._index.items():
            assert self._block_hash.get(b) == digest, \
                f"index/digest mismatch for block {b}"
            assert b in self._block_tokens, f"indexed block {b} lost tokens"
        for slot, blocks in enumerate(self._owned):
            if blocks:
                assert self._occupied[slot], \
                    f"unoccupied slot {slot} owns blocks"
            assert self.lengths[slot] <= len(blocks) * self.block_size
            assert (self.lengths[slot]
                    <= self.max_blocks_per_slot * self.block_size), \
                f"slot {slot} length exceeds table capacity"
            assert list(self.block_tables[slot, :len(blocks)]) == blocks
            assert (self.block_tables[slot, len(blocks):] == 0).all()
            assert self._nseal[slot] <= len(blocks)
            if self._chain[slot] is not None:
                assert (self._nseal[slot] * self.block_size
                        + len(self._pending[slot]) == self.lengths[slot]), \
                    f"slot {slot} sealing accounting broken"
                assert (len(self._chain_stack[slot])
                        == self._nseal[slot] + 1), \
                    f"slot {slot} chain history out of sync with seals"
                assert self._chain_stack[slot][-1] == self._chain[slot], \
                    f"slot {slot} chain digest diverged from its history"
                assert len(self._seal_toks[slot]) == self._nseal[slot], \
                    f"slot {slot} seal-token history out of sync"

    # ---- device views -----------------------------------------------------
    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block tables and lengths as int32 tensors on ``device``:
        snapshots (:func:`to_device`), since these buffers are mutated in
        place (admit/growth/rollback/release) while a dispatched chunk may
        still read the tensors handed to it."""
        return to_device(self.block_tables, device), to_device(self.lengths,
                                                               device)

    @property
    def idle(self) -> bool:
        """No slot occupied — safe to hand the pool to a new stream."""
        return not any(self._occupied)


def reset_slot(cache, slot: int):
    """Zero one slot's dense per-slot state in a paged decode cache (in
    place): a mamba layer's ``h`` (slots, H, P, N) and ``conv`` (slots,
    K-1, conv_dim) rows at ``slot``, whatever dtype the conv state has
    taken.  K/V pool blocks need no reset — the per-row length mask
    excludes never-written positions, and prefix-cached blocks must keep
    their content across owners — so for an attention-only model this
    touches nothing."""
    for entry in cache["layers"]:
        for key, leaf in entry.items():
            if key not in ("k_pool", "v_pool", "k_scale", "v_scale"):
                leaf[slot].zero_()
    return cache

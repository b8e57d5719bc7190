"""Continuous-batching scheduler: admission, growth, preemption, progress.

Sits between a request queue and the paged prefill/decode steps.  Each
serving slot tracks one in-flight request's lifecycle:

    queued -> admitted (slot claimed, zero private blocks, SSM state reset;
              with prefix caching, the prompt's longest cached prefix is
              mapped in refcounted and skipped — ``fed`` starts past it)
           -> prefilling (remaining prompt CHUNKS fed per prefill dispatch)
           -> decoding  (sampled tokens emitted and fed back, chunked)
           -> finished  (budget exhausted or EOS) -> slot + blocks freed
        or -> preempted (blocks released; requeued with prompt+emitted as
              the new prompt, so no work is lost)

Blocks are allocated on demand: :meth:`prepare_chunk` plans the next device
chunk (a prefill chunk while any active slot still has prompt tokens
pending, else a decode chunk) and grows every active slot's block table to
cover exactly the positions that chunk will write — oldest request first.
When the pool runs dry mid-growth a victim is preempted and planning
restarts.

**Scheduling policy** (``policy=``): requests carry a *priority class*
(:data:`PRIORITY_CLASSES`: ``interactive`` < ``batch`` < ``background``)
and an optional deadline.

* ``"sla"`` (default) — admission is a priority queue: candidates order by
  ``(effective class, deadline, arrival)`` where the effective class is
  AGED one level towards ``interactive`` every ``aging_ticks`` admission
  rounds spent queued, so a starved ``background`` request climbs to the
  top class in bounded time and then blocks younger admissions until it
  fits (no starvation).  Preemption victims come from the LOWEST priority
  class among the candidates; inside it the legacy newest-first pick is
  kept unless a candidate is structurally cheaper in the worst case —
  its guaranteed re-prefill cost (context minus the prefix co-owned by
  another live slot, which survives any eviction and re-matches at
  re-admission) undercuts the newest's by at least a block and its
  release covers the pool's shortfall (see :func:`sla_victim`).  The
  progress bound is preserved: the oldest runnable request in the top
  priority class among the active slots is never preempted, so it always
  completes (no livelock) as long as every request's full span fits the
  pool alone (checked at submit).
* ``"fcfs"`` — the legacy behaviour: arrival-order admission (priorities
  ignored) and newest-request-first victims.

A custom victim policy (``victim_policy=``) receives the non-protected
:class:`VictimInfo` candidates and returns the slot to preempt.

The engine drives the loop in chunks:  ``admit()`` between chunks pulls
queued requests into freed slots (the best candidate waits while free
blocks can't cover its prompt — no bypass, which is what makes aging a
starvation bound), ``prepare_chunk()`` plans + grows + preempts,
``prefill_arrays()``/``chunk_arrays()`` snapshot per-slot state for the
device dispatch, and ``observe_prefill()``/``observe_chunk()`` consume the
sampled results, returning ``(rid, new_tokens, finished)`` events the
moment tokens exist — the streaming API yields them before the batch
drains.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
from repro_torch.serving.spec_decode import propose_draft

# priority classes, most to least urgent (lower level = more urgent)
PRIORITY_CLASSES: Dict[str, int] = {
    "interactive": 0, "batch": 1, "background": 2}
_LEVEL_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


@dataclasses.dataclass(frozen=True)
class VictimInfo:
    """One preemption candidate, as seen by a victim policy."""
    slot: int
    rid: int
    seq: int                      # arrival order (stable across preemptions)
    level: int                    # priority class level (0 = interactive)
    emitted: int                  # tokens emitted this incarnation
    context_len: int              # K/V positions written (kv.lengths[slot])
    block_size: int
    sealed_tokens: int            # leading context in SEALED blocks: these
    #                               park content-addressed on release and
    #                               re-match at re-admission (unless pool
    #                               pressure evicts them first)
    sealed_fraction: float        # of owned blocks, sealed/content-indexed
    shared_prefix_tokens: int     # of sealed_tokens, the prefix co-owned by
    #                               another slot — survives release for sure
    releasable_blocks: int        # blocks a release makes allocatable
    #                               (refcount-1; co-owned blocks yield 0)
    prompt_len: int
    fed: int
    deadline: Optional[float] = None  # the request's SLA deadline; None =
    #                               unbounded slack (sorts as +inf: the
    #                               safest victim among deadlined peers)

    @property
    def _cap(self) -> int:
        """Most tokens the replay can possibly re-match: its last full
        block boundary (admission matching leaves at least one token live,
        see ``PagedKVCache.match_prefix``)."""
        replay = self.prompt_len + self.emitted
        return ((replay - 1) // self.block_size) * self.block_size

    @property
    def reprefill_cost(self) -> int:
        """Optimistic re-prefill estimate: context minus the whole sealed
        prefix (assumes parked blocks survive until re-admission — usually
        true under mild pressure).  Always < 2 blocks, so it cannot tell
        victims apart; kept for stats and custom policies."""
        return self.context_len - min(self.sealed_tokens, self._cap)

    @property
    def guaranteed_cost(self) -> int:
        """Pessimistic (worst-case) re-prefill: context minus only the
        prefix CO-OWNED by another active slot — those blocks stay
        referenced through the preemption, immune to eviction, so the
        replay re-matches them no matter how hard the pool thrashes.
        Unlike the optimistic estimate this separates victims structurally:
        ~0 for a request riding a live shared prefix, the full context for
        a unique one."""
        return self.context_len - min(self.shared_prefix_tokens, self._cap)


def sla_victim(cands: List[VictimInfo], short: int = 1) -> int:
    """Default victim policy: prefer the lowest-priority class; inside it,
    keep the legacy newest-first choice (LIFO concentrates preemption
    churn on one young request — empirically hard to beat) UNLESS a
    candidate is structurally cheaper in the WORST case: its guaranteed
    re-prefill cost (counting only blocks co-owned by another live slot,
    which survive any eviction pressure) undercuts the newest's by at
    least a block, and its release alone covers the ``short`` blocks the
    pool is missing (a deviation that still forces a second preemption
    pays twice).  Then take the cheapest such candidate (newest on ties).
    With nothing cached/co-owned no candidate qualifies and this IS
    newest-first.

    Deadlines refine the within-class pick: the LATEST-deadline candidate
    (most slack — a deadline-less request counts as infinite slack) is the
    preferred victim among same-class peers, arrival order breaking exact
    ties as before.  With no deadlines set every candidate has infinite
    slack and the policy reduces to the legacy newest-first behaviour."""
    lvl = max(c.level for c in cands)
    pool = [c for c in cands if c.level == lvl]
    slack = (lambda c: math.inf if c.deadline is None else c.deadline)
    newest = max(pool, key=lambda c: (slack(c), c.seq))
    cheap = [c for c in pool if c.releasable_blocks >= max(1, short)
             and c.guaranteed_cost + c.block_size <= newest.guaranteed_cost]
    if not cheap:
        return newest.slot
    return min(cheap, key=lambda c: (c.guaranteed_cost, -slack(c),
                                     -c.seq)).slot


def newest_victim(cands: List[VictimInfo]) -> int:
    """Legacy victim policy: preempt the newest request."""
    return max(cands, key=lambda c: c.seq).slot


@dataclasses.dataclass
class _ReqMeta:
    level: int
    deadline: Optional[float]     # admission-priority tie-break (EDF); None
    #                               sorts after any deadlined peer in class
    seq: int                      # arrival order, preserved across preempts
    enqueue_tick: int             # (re)entered the queue at this tick
    arrival_time: Optional[float] = None  # open-loop arrival (monotonic
    #                               seconds); set by the session when driven
    #                               by a trace/server — admission then also
    #                               records WALL-CLOCK queue waits


@dataclasses.dataclass
class _SlotState:
    rid: int
    client_id: Any
    prompt: np.ndarray            # (S,) int32 — original prompt + any tokens
    #                               emitted before a preemption (replayed)
    budget: int                   # tokens still to emit this incarnation
    next_token: int               # token the next decode step feeds
    fed: int = 0                  # tokens already fed (prompt + emitted);
    #                               starts PAST a matched cached prefix
    emitted: List[int] = dataclasses.field(default_factory=list)
    prior: List[int] = dataclasses.field(default_factory=list)
    #                               tokens emitted before preemption(s)
    draft: List[int] = dataclasses.field(default_factory=list)
    #                               speculative tokens proposed for the NEXT
    #                               verify dispatch — planning-local state,
    #                               never part of emitted/prompt until a
    #                               verify ACCEPTS them (so a preemption
    #                               between planning and observe can never
    #                               leak drafts into the requeued prompt)


class Scheduler:
    """Priority admission over ``kv.num_slots`` slots; results keyed by rid.

    ``policy``: ``"sla"`` (priority classes + aging + scored victims) or
    ``"fcfs"`` (legacy arrival order + newest-first victims).
    ``aging_ticks``: admission rounds queued per one-class promotion under
    ``"sla"`` (0 disables aging).  ``victim_policy``: optional callable
    ``List[VictimInfo] -> slot`` replacing the default victim scoring
    (candidates already exclude the protected oldest top-class request).
    """

    def __init__(self, kv: PagedKVCache, policy: str = "sla",
                 aging_ticks: int = 16,
                 victim_policy: Optional[
                     Callable[[List[VictimInfo]], int]] = None,
                 spec_k: int = 0, spec_ngram: int = 3):
        if policy not in ("sla", "fcfs"):
            raise ValueError(f"unknown sched policy {policy!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.kv = kv
        self.policy = policy
        self.aging_ticks = aging_ticks
        self.victim_policy = victim_policy
        # speculative decoding: spec_k > 0 turns decode chunks into
        # draft-then-verify chunks (prompt-lookup drafts of up to spec_k
        # tokens, matched over <= spec_ngram trailing tokens) whenever any
        # decoding slot has a proposal; greedy-only (the engine enforces it)
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        # queue entries: (rid, client_id, prompt, budget, prior_emitted)
        self._queue: "deque[Tuple[int, Any, np.ndarray, int, List[int]]]" = \
            deque()
        self._slots: List[Optional[_SlotState]] = [None] * kv.num_slots
        self.results: Dict[int, np.ndarray] = {}
        self._scopes: Dict[int, Any] = {}   # rid -> prefix-cache hash scope
        self._meta: Dict[int, _ReqMeta] = {}  # rid -> priority bookkeeping
        self._seq = 0                       # arrival counter
        self.ticks = 0                      # admission rounds (aging clock)
        self.steps = 0                      # decode steps driven
        self.prefill_dispatches = 0         # prefill chunks dispatched
        self.decode_dispatches = 0          # decode chunks dispatched
        self.verify_dispatches = 0          # draft-verify chunks dispatched
        self.drafted_tokens = 0             # speculative tokens proposed
        self.accepted_tokens = 0            # of those, greedy-accepted
        self.rollback_tokens = 0            # drafted positions rolled back
        self.rollback_blocks = 0            # tail blocks freed by rollback
        self.preemptions = 0
        self.preemptions_by_class: Dict[str, int] = {}
        self.victim_sealed_fractions: List[float] = []
        self.wait_ticks: Dict[str, List[int]] = {}  # class -> per-admission
        #                                     queue waits (incl. re-admits)
        self.wait_wall: Dict[str, List[float]] = {}  # class -> wall-clock
        #                                     queue waits in SECONDS, only
        #                                     for requests submitted with an
        #                                     arrival_time (open-loop); a
        #                                     re-admission after preemption
        #                                     measures from the ORIGINAL
        #                                     arrival (user-visible delay)
        self.prompt_tokens = 0              # prompt tokens admitted (incl.
        #                                     preemption replays)
        self.prefix_hit_tokens = 0          # of those, served from cache

    # ---- intake -----------------------------------------------------------
    def submit(self, rid: int, client_id: Any, prompt, budget: int,
               scope: Any = None, priority: str = "batch",
               deadline: Optional[float] = None,
               arrival_time: Optional[float] = None) -> None:
        """``scope`` isolates the request's prefix-cache hash chain (the
        engine passes ``(client_id, adapter version)`` — cached K/V depends
        on the adapter); ``None`` falls back to ``client_id``.
        ``priority`` names a :data:`PRIORITY_CLASSES` entry; ``deadline``
        (optional, any comparable number — the engine passes it through
        untouched) breaks admission ties earliest-first within a class,
        deadline-less requests sorting last.  ``arrival_time`` (optional,
        ``time.monotonic()`` seconds) marks the request as OPEN-LOOP:
        admission then also records its wall-clock queue wait in
        :attr:`wait_wall` next to the round-based :attr:`wait_ticks`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {rid}: empty prompt")
        if budget < 1:
            raise ValueError(f"request {rid}: budget must be >= 1")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"request {rid}: unknown priority {priority!r} "
                             f"(have {sorted(PRIORITY_CLASSES)})")
        span = int(prompt.size) + budget
        if not self.kv.fits(span):
            raise ValueError(
                f"request {rid}: span {span} exceeds cache capacity "
                f"({self.kv.max_blocks_per_slot} blocks of "
                f"{self.kv.block_size})")
        self._scopes[rid] = client_id if scope is None else scope
        self._meta[rid] = _ReqMeta(PRIORITY_CLASSES[priority], deadline,
                                   self._seq, self.ticks,
                                   arrival_time=arrival_time)
        self._seq += 1
        self._queue.append((rid, client_id, prompt, budget, []))

    # ---- priority ordering -------------------------------------------------
    def effective_level(self, rid: int) -> int:
        """The request's class level after aging: one level more urgent per
        ``aging_ticks`` admission rounds spent queued (clamped at the top
        class).  This is the starvation bound — any request reaches level 0
        within ``level * aging_ticks`` rounds and then admits before every
        younger level-0 request."""
        m = self._meta[rid]
        if self.policy != "sla" or self.aging_ticks <= 0:
            return m.level
        return max(0, m.level - (self.ticks - m.enqueue_tick)
                   // self.aging_ticks)

    def _admit_key(self, rid: int):
        m = self._meta[rid]
        if self.policy == "fcfs":
            return (m.seq,)
        return (self.effective_level(rid),
                m.deadline if m.deadline is not None else math.inf, m.seq)

    # ---- state ------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queued(self) -> bool:
        """True while any request waits for admission."""
        return bool(self._queue)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    @property
    def prefill_pending(self) -> bool:
        return any(s is not None and s.fed < s.prompt.size
                   for s in self._slots)

    # ---- lifecycle --------------------------------------------------------
    def admit(self) -> List[Tuple[int, Any]]:
        """Fill freed slots from the queue in admission-priority order;
        returns newly admitted ``(slot, client_id)`` pairs (the engine
        resets SSM state and resolves the adapter slot for each).
        Admission claims a slot with zero blocks — the BEST candidate waits
        while the free list can't cover its prompt (no lower-priority
        bypass: combined with aging this is the starvation bound), and
        growth past the prompt relies on preemption.  Each call advances
        the aging clock one tick.

        With prefix caching, admission matches the prompt's longest cached
        prefix under the request's scope and starts ``fed`` past the hit —
        those positions are never re-prefilled (a preempted request
        re-admitted with prompt+emitted re-matches its own sealed blocks)."""
        self.ticks += 1
        admitted = []
        free = [s for s, st in enumerate(self._slots) if st is None]
        while free and self._queue:
            idx = min(range(len(self._queue)),
                      key=lambda i: self._admit_key(self._queue[i][0]))
            rid, cid, prompt, budget, prior = self._queue[idx]
            if not self.kv.can_admit(int(prompt.size)):
                break                        # best candidate waits; no bypass
            del self._queue[idx]
            slot = free.pop(0)
            n_hit = self.kv.admit(slot, scope=self._scopes[rid],
                                  tokens=prompt)
            self._slots[slot] = _SlotState(rid, cid, prompt, budget,
                                           next_token=int(prompt[0]),
                                           fed=n_hit, prior=prior)
            m = self._meta[rid]
            self.wait_ticks.setdefault(_LEVEL_NAMES[m.level], []).append(
                self.ticks - m.enqueue_tick)
            if m.arrival_time is not None:
                self.wait_wall.setdefault(_LEVEL_NAMES[m.level], []).append(
                    time.monotonic() - m.arrival_time)
            self.prompt_tokens += int(prompt.size)
            self.prefix_hit_tokens += n_hit
            admitted.append((slot, cid))
        return admitted

    def preempt(self, slot: int) -> int:
        """Release ``slot``'s blocks and requeue its request at the queue
        head with prompt+emitted as the new prompt (emitted-so-far moves to
        ``prior``), so the resumed incarnation replays its context and
        continues from the exact same state — no work is lost.  The request
        keeps its arrival ``seq`` (it stays ahead of younger peers in its
        class); its aging clock restarts.  Returns the preempted rid."""
        st = self._slots[slot]
        assert st is not None, f"slot {slot} not active"
        m = self._meta[st.rid]
        self.victim_sealed_fractions.append(self.kv.sealed_fraction(slot))
        cname = _LEVEL_NAMES[m.level]
        self.preemptions_by_class[cname] = \
            self.preemptions_by_class.get(cname, 0) + 1
        m.enqueue_tick = self.ticks
        # zero-emitted edge: requeue the original array untouched (an empty
        # concatenand must not copy or silently re-derive the dtype)
        new_prompt = st.prompt if not st.emitted else np.concatenate(
            [st.prompt, np.asarray(st.emitted, np.int32)])
        self._queue.appendleft((st.rid, st.client_id, new_prompt,
                                st.budget - len(st.emitted),
                                st.prior + st.emitted))
        self.kv.release(slot)
        self._slots[slot] = None
        self.preemptions += 1
        return st.rid

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        self.results[st.rid] = np.asarray(st.prior + st.emitted, np.int32)
        self.kv.release(slot)
        self._slots[slot] = None

    # ---- chunk planning ----------------------------------------------------
    def plan_steps(self, cap: int) -> int:
        """Decode steps until the EARLIEST active slot completes its budget.
        ``cap`` bounds the chunk (keep small under EOS so early-stopping
        rows don't burn steps until the boundary).  Returns 1 when no slot
        is active (nothing to plan — the engine admits and retries)."""
        remaining = [st.prompt.size - 1 + st.budget - st.fed
                     for st in self._slots if st is not None]
        if not remaining:
            return 1
        return max(1, min(min(remaining), cap))

    def _pick_victim(self, grower: int, short: int = 1) -> int:
        """The slot to preempt when growing ``grower`` found the pool dry
        (``short`` = blocks the pool is missing for the grower's target).

        ``"fcfs"``: the newest active request (legacy).  ``"sla"``: the
        oldest active request of the top priority class present is
        PROTECTED (progress bound — it always completes); the remaining
        candidates go to ``victim_policy`` (default :func:`sla_victim`,
        which also sees ``short``; custom policies get the candidate list
        only).  When the grower is the only candidate it is returned (the
        caller's self-preempt / single-request paths handle it)."""
        active = [(st, s) for s, st in enumerate(self._slots)
                  if st is not None]
        if self.policy == "fcfs":
            return max(active, key=lambda p: self._meta[p[0].rid].seq)[1]
        top = min(self._meta[st.rid].level for st, _ in active)
        protected = min((p for p in active
                         if self._meta[p[0].rid].level == top),
                        key=lambda p: self._meta[p[0].rid].seq)[1]
        cands = [VictimInfo(slot=s, rid=st.rid,
                            seq=self._meta[st.rid].seq,
                            level=self._meta[st.rid].level,
                            emitted=len(st.emitted),
                            context_len=int(self.kv.lengths[s]),
                            block_size=self.kv.block_size,
                            sealed_tokens=self.kv.sealed_tokens(s),
                            sealed_fraction=self.kv.sealed_fraction(s),
                            shared_prefix_tokens=
                            self.kv.shared_prefix_tokens(s),
                            releasable_blocks=self.kv.releasable_blocks(s),
                            prompt_len=int(st.prompt.size), fed=st.fed,
                            deadline=self._meta[st.rid].deadline)
                 for st, s in active if s != protected]
        if not cands:
            return protected             # grower alone; caller raises/replans
        if self.victim_policy is not None:
            return self.victim_policy(cands)
        return sla_victim(cands, short=short)

    def _draft(self, slot: int) -> List[int]:
        """Prompt-lookup proposal for a DECODING slot, capped so the verify
        chunk can neither overshoot the request's budget (at most
        ``remaining - 1`` drafts: the bonus token the verify emits at the
        draft-free position accounts for the rest) nor its table capacity
        (the dispatch transiently writes all drafted positions before
        rollback trims the rejects)."""
        st = self._slots[slot]
        remaining = st.budget - len(st.emitted)
        cap_tokens = self.kv.max_blocks_per_slot * self.kv.block_size
        k = min(self.spec_k, remaining - 1,
                cap_tokens - int(self.kv.lengths[slot]) - 1)
        if k <= 0:
            return []
        history = [int(t) for t in st.prompt] + st.emitted
        return propose_draft(history, k, max_ngram=self.spec_ngram)

    def _decode_cap(self, decode_cap: int) -> int:
        """With spec enabled keep decode chunks short — drafts are
        recomputed only at chunk boundaries, and a full-budget chunk would
        never give the drafter a second look at the (by then repetitive)
        history."""
        return (min(decode_cap, self.spec_k + 1) if self.spec_k > 0
                else decode_cap)

    def preferred_round(self, decode_cap: int):
        """The round this scheduler would plan next, WITHOUT growing any
        block table: ``("prefill", None)``, ``("verify", None)``,
        ``("decode", n_steps)`` or None when no slot is active.  Drafts are
        computed (and stored on the slots) as a side effect, exactly as the
        auto path of :meth:`prepare_chunk` would.

        A multi-shard coordinator calls this on every shard, negotiates one
        global round kind (any prefill wins; else any verify; else decode
        with the min step count), then forces it back through
        :meth:`prepare_chunk(kind=..., steps=...)` so the fused dispatch
        runs one round shape across all shards."""
        if not self.active_slots:
            return None
        if self.prefill_pending:
            return ("prefill", None)
        if self.spec_k > 0:
            verify = False
            for slot in self.active_slots:
                st = self._slots[slot]
                st.draft = self._draft(slot)
                verify = verify or bool(st.draft)
            if verify:
                return ("verify", None)
        return ("decode", self.plan_steps(self._decode_cap(decode_cap)))

    def prepare_chunk(self, prefill_chunk: int, decode_cap: int,
                      kind: Optional[str] = None,
                      steps: Optional[int] = None):
        """Plan the next device chunk under on-demand block growth.

        Grows each active slot (oldest rid first) to cover the positions
        the chunk will write; when the pool runs dry, preempts a victim
        (see :meth:`_pick_victim`) and replans.  Returns
        ``("prefill", None)``, ``("verify", None)`` or
        ``("decode", n_steps)``, or None when no slot is active.

        With ``spec_k > 0`` and no prompt tokens pending, each decoding
        slot gets a prompt-lookup draft; if ANY slot drafted, the chunk is
        a VERIFY chunk — drafting slots feed ``1 + len(draft)`` tokens,
        non-drafting slots ride along as plain 1-token feedback rows (the
        same mixed planning that lets decode ride prefill chunks).  With
        no drafts anywhere the multi-step decode chunk is strictly better
        and is planned as before.  Drafts live only in ``_SlotState.draft``
        until :meth:`observe_verify` accepts them, so a preemption landing
        mid-plan (pool-dry growth below) requeues prompt+emitted ONLY —
        draft tokens never leak into a replayed prompt.

        ``kind`` forces the round shape (multi-shard coordination: every
        shard of a fused dispatch must plan the same kind).  A forced
        ``"prefill"`` on a shard with no prompt pending plans all-feedback
        rows; a forced ``"verify"`` with no local drafts plans 1-token
        rows; a forced ``"decode"`` with ``steps`` runs exactly that many
        steps (the coordinator passes the min over shards, so no slot
        overshoots its budget).  ``kind=None`` (single-pool path) is
        byte-identical to the pre-shard planner."""
        while True:
            active = sorted((st.rid, slot)
                            for slot, st in enumerate(self._slots)
                            if st is not None)
            if not active:
                return None
            prefill = (self.prefill_pending if kind is None
                       else kind == "prefill")
            verify = False
            targets = {}
            if prefill:
                for _, slot in active:
                    st = self._slots[slot]
                    st.draft = []
                    rem = st.prompt.size - st.fed
                    # slots already decoding ride along as 1-token feedback
                    # rows (no decode stall behind another slot's prompt)
                    n = min(prefill_chunk, rem) if rem > 0 else 1
                    targets[slot] = int(self.kv.lengths[slot]) + n
            else:
                if self.spec_k > 0 and kind != "decode":
                    for _, slot in active:
                        st = self._slots[slot]
                        st.draft = self._draft(slot)
                        verify = verify or bool(st.draft)
                verify = verify or kind == "verify"
                if verify:
                    for _, slot in active:
                        st = self._slots[slot]
                        targets[slot] = (int(self.kv.lengths[slot])
                                         + 1 + len(st.draft))
                else:
                    for _, slot in active:
                        self._slots[slot].draft = []
                    n = (steps if steps is not None
                         else self.plan_steps(self._decode_cap(decode_cap)))
                    for _, slot in active:
                        targets[slot] = int(self.kv.lengths[slot]) + n
            preempted = False
            for _, slot in active:           # oldest request claims first
                if self._slots[slot] is None:
                    continue                 # preempted earlier in this pass
                while not self.kv.ensure(slot, targets[slot]):
                    need = (blocks_needed(targets[slot], self.kv.block_size)
                            - self.kv.owned_blocks(slot))
                    victim = self._pick_victim(
                        slot, short=need - self.kv.allocatable_blocks)
                    if victim == slot and len(self.active_slots) == 1:
                        raise RuntimeError(
                            "pool cannot hold a single request's span "
                            "(submit() should have rejected it)")
                    self.preempt(victim)
                    preempted = True
                    if victim == slot:
                        break                # self-preempted; replan
            if not preempted:
                if prefill:
                    return ("prefill", None)
                return ("verify", None) if verify else ("decode", n)

    # ---- prefill chunks ----------------------------------------------------
    def prefill_arrays(self, width: int):
        """Per-slot token chunks for one prefill dispatch: ``tokens``
        (K, width) int32 padded, ``n_new`` (K,) valid counts.  Slots still
        prefilling feed their next prompt chunk; slots already DECODING
        ride along as 1-token feedback rows (``tokens[i, 0] = last
        sample``) so decode never stalls behind another slot's prompt —
        a 1-token prefill row is bitwise-identical to a decode step."""
        K = self.kv.num_slots
        out = {"tokens": np.zeros((K, width), np.int32),
               "n_new": np.zeros((K,), np.int32)}
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            n = min(width, st.prompt.size - st.fed)
            if n > 0:
                out["tokens"][i, :n] = st.prompt[st.fed:st.fed + n]
                out["n_new"][i] = n
            else:                            # decoding: feedback row
                out["tokens"][i, 0] = st.next_token
                out["n_new"][i] = 1
        return out

    def chunk_emits(self, n_new: np.ndarray) -> bool:
        """Whether a prefill chunk planned with these per-slot ``n_new``
        counts will EMIT any token — i.e. whether :meth:`observe_prefill`
        will read the sampled array at all.  True when some slot rides as a
        decoding feedback row or completes its prompt inside the chunk.  A
        pure function of host state, so the engine's overlapped dispatch
        path can decide BEFORE the device finishes whether the next plan
        depends on this chunk's samples (it materialises only when it
        does — the async-overlap sync rule)."""
        for slot, st in enumerate(self._slots):
            if st is None or n_new[slot] == 0:
                continue
            if st.fed >= st.prompt.size:          # decoding feedback row
                return True
            if st.fed + int(n_new[slot]) >= st.prompt.size:
                return True                       # prompt completes: emits
        return False

    def observe_prefill(self, n_new: np.ndarray, sampled: np.ndarray,
                        eos_id: Optional[int] = None
                        ) -> List[Tuple[int, List[int], bool]]:
        """Consume one prefill chunk: ``n_new[slot]`` tokens were written
        for each slot and ``sampled[slot]`` is the sample at the slot's
        last valid position.  A slot whose prompt just completed records
        that sample as its first emission; a slot that rode along as a
        decoding feedback row records it as its next emission.  Returns
        (rid, new_tokens, finished) events."""
        events = []
        for slot, st in enumerate(self._slots):
            if st is None or n_new[slot] == 0:
                continue
            n = int(n_new[slot])
            decoding = st.fed >= st.prompt.size   # feedback row (n == 1)
            written = ([st.next_token] if decoding
                       else [int(t) for t in st.prompt[st.fed:st.fed + n]])
            st.fed += n
            self.kv.advance(slot, n, tokens=written)
            if decoding or st.fed == st.prompt.size:
                tok = int(sampled[slot])
                st.emitted.append(tok)
                st.next_token = tok
                done = (len(st.emitted) >= st.budget
                        or (eos_id is not None and tok == eos_id))
                rid = st.rid
                if done:
                    self._finish(slot)
                events.append((rid, [tok], done))
        self.prefill_dispatches += 1
        return events

    # ---- verify chunks (speculative decoding) ------------------------------
    # A verify chunk is a prefill-shaped dispatch over DECODING slots: each
    # slot feeds its pending feedback token plus its draft, the model scores
    # the whole chunk causally in ONE evaluation (bitwise-equal to feeding
    # the same tokens one decode step at a time — the chunked-prefill
    # property), and the greedy samples at every position come back so
    # observe_verify can accept the longest matching run.

    def verify_arrays(self, width: int):
        """Per-slot token chunks for one verify dispatch: ``tokens``
        (K, width) int32 padded, ``n_new`` (K,) valid counts.  Row ``i``
        feeds ``[next_token, draft...]`` — a draft-less slot is exactly a
        1-token decode feedback row.  ``width`` must cover ``1 + spec_k``
        (fixed per stream so the verify program compiles once)."""
        K = self.kv.num_slots
        out = {"tokens": np.zeros((K, width), np.int32),
               "n_new": np.zeros((K,), np.int32)}
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            assert st.fed >= st.prompt.size, \
                f"slot {i} entered a verify chunk mid-prefill"
            n = 1 + len(st.draft)
            assert n <= width, (n, width)
            out["tokens"][i, 0] = st.next_token
            out["tokens"][i, 1:n] = st.draft
            out["n_new"][i] = n
        return out

    def observe_verify(self, n_new: np.ndarray, greedy: np.ndarray,
                       eos_id: Optional[int] = None
                       ) -> List[Tuple[int, List[int], bool]]:
        """Consume one verify dispatch: ``greedy[slot, t]`` is the model's
        greedy sample after feeding the slot's chunk tokens up to and
        including position ``t``.  Accepts the longest run where each
        drafted token equals the PREVIOUS position's greedy sample (the
        token non-speculative decoding would have fed), emitting one
        greedy token per accepted position plus the bonus sample at the
        last accepted one — bitwise-identical to non-speculative greedy
        decoding.  The K/V written for rejected draft positions is rolled
        back (:meth:`PagedKVCache.rollback`), freeing over-allocated tail
        blocks.  Returns (rid, new_tokens, finished) events."""
        events = []
        for slot, st in enumerate(self._slots):
            if st is None or n_new[slot] == 0:
                continue
            k = int(n_new[slot]) - 1
            draft = st.draft
            assert len(draft) == k, (len(draft), k)
            g = [int(greedy[slot, t]) for t in range(k + 1)]
            a = 0
            while a < k and draft[a] == g[a]:
                a += 1
            # chunk fed [next_token, draft...]: advance the cache through
            # every written position (sealing with the true written ids),
            # then roll back past the first mismatch — rejected positions
            # leave lengths, tables, digests and pending as if never fed
            pre = int(self.kv.lengths[slot])
            self.kv.advance(slot, 1 + k,
                            tokens=[st.next_token] + list(draft))
            self.rollback_blocks += self.kv.rollback(slot, pre + 1 + a)
            st.fed += 1 + a
            st.draft = []
            self.drafted_tokens += k
            self.accepted_tokens += a
            self.rollback_tokens += k - a
            new_toks: List[int] = []
            done = False
            for tok in g[:a + 1]:            # g[i] emits after accepting i
                st.emitted.append(tok)
                new_toks.append(tok)
                if (len(st.emitted) >= st.budget
                        or (eos_id is not None and tok == eos_id)):
                    done = True
                    break
            if done:
                rid = st.rid
                self._finish(slot)
                events.append((rid, new_toks, True))
            else:
                st.next_token = new_toks[-1]
                events.append((st.rid, new_toks, False))
        self.verify_dispatches += 1
        return events

    # ---- decode chunks -----------------------------------------------------
    # One host round-trip per token kills throughput: the engine runs up to
    # plan_steps() decode steps back to back on the device (each slot
    # feeding its last sampled token) and hands the sampled block back to
    # observe_chunk.  (A per-token driver is just observe_chunk with a
    # (1, num_slots) block.)

    def chunk_arrays(self):
        """Per-slot device state for one decode chunk: last-fed token and
        active mask.  (Prompts are fed by prefill chunks — every active
        slot here resumes from its last sample.)"""
        K = self.kv.num_slots
        out = {"last": np.zeros((K,), np.int32),
               "active": np.zeros((K,), np.int32)}
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            out["last"][i] = st.next_token
            out["active"][i] = 1
        return out

    def observe_chunk(self, sampled: np.ndarray,
                      eos_id: Optional[int] = None
                      ) -> List[Tuple[int, List[int], bool]]:
        """Consume an (n, num_slots) block of decode samples (step-major);
        returns (rid, new_tokens, finished) events.  Decode chunks only run
        once every active slot is past its prompt (prefill chunks fed it
        and recorded the first emission), so step t of slot i fed the
        previous sample and ``sampled[t, i]`` is always an emission."""
        n = sampled.shape[0]
        events = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            assert st.fed >= st.prompt.size, \
                f"slot {slot} entered a decode chunk mid-prefill"
            # step 0 fed (and wrote) next_token; step t>0 fed sampled[t-1]
            written = [st.next_token] + [int(sampled[t, slot])
                                         for t in range(n - 1)]
            new_toks: List[int] = []
            done = False
            for t in range(n):
                tok = int(sampled[t, slot])
                st.emitted.append(tok)
                new_toks.append(tok)
                if (len(st.emitted) >= st.budget
                        or (eos_id is not None and tok == eos_id)):
                    done = True
                    break
            st.fed += n
            self.kv.advance(slot, n, tokens=written)
            if done:
                rid = st.rid
                self._finish(slot)
                events.append((rid, new_toks, True))
            else:
                st.next_token = int(sampled[n - 1, slot])
                events.append((st.rid, new_toks, False))
        self.steps += n
        self.decode_dispatches += 1
        return events

    # ---- deferred observation (overlap pipelining) -------------------------
    def chunk_defer_safe(self, n: int) -> bool:
        """True when the NEXT chunk plan provably does not depend on the
        token VALUES an ``n``-step decode chunk will sample: every active
        slot has strictly more than ``n`` tokens of budget left, so no slot
        finishes inside the chunk (``plan_steps`` stops at the earliest
        boundary, so this is exactly "the chunk was cap-limited") and the
        active set cannot churn.  Only count bookkeeping remains, which
        ``observe_chunk_counts`` advances without the samples — the engine
        combines this with its config gates (no EOS, no speculation, no
        prefix sealing) before deferring materialisation one round."""
        return all(st.prompt.size - 1 + st.budget - st.fed > n
                   for st in self._slots if st is not None)

    def observe_chunk_counts(self, n: int) -> List[int]:
        """Count half of :meth:`observe_chunk`, for a DEFERRED decode
        chunk: advance ``fed``, the pool lengths and the dispatch counters
        — everything the next chunk PLAN reads — while the sampled values
        are still on device.  The caller guarantees ``chunk_defer_safe(n)``
        held at plan time and that prefix sealing is off (``advance`` gets
        no tokens).  Returns the participating slot ids, to be replayed
        through :meth:`observe_chunk_values` once the samples land."""
        slots = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            assert st.fed >= st.prompt.size, \
                f"slot {slot} entered a decode chunk mid-prefill"
            st.fed += n
            self.kv.advance(slot, n)
            slots.append(slot)
        self.steps += n
        self.decode_dispatches += 1
        return slots

    def observe_chunk_values(self, slots: List[int], sampled: np.ndarray
                             ) -> List[Tuple[int, List[int], bool]]:
        """Value half: fold the now-materialised samples of a chunk whose
        counts already advanced into the emitted streams — one engine round
        late.  ``chunk_defer_safe`` ruled out finishes, so every row
        survives and just chains ``next_token`` forward; the token values
        per rid are bitwise what the synchronous path would have emitted,
        only their event round shifts."""
        n = sampled.shape[0]
        events = []
        for slot in slots:
            st = self._slots[slot]
            assert st is not None, \
                f"deferred slot {slot} vanished before its flush"
            toks = [int(sampled[t, slot]) for t in range(n)]
            st.emitted.extend(toks)
            st.next_token = toks[-1]
            events.append((st.rid, toks, False))
        return events

"""Multi-tenant serving engine: continuous batching over a paged KV pool.

Port of ``repro/serving/engine.py`` (``MultiTenantEngine`` and
``StreamSession``, the synchronous loop).  Requests carry a ``client_id``;
each batch row is routed to its client's slot of the
:class:`~repro_torch.serving.registry.AdapterRegistry` bank through
per-row ``adapter_ids``.  Ragged prompts are fed by CHUNKED prefill
dispatches, blocks are allocated on demand, a victim is preempted when
the pool runs dry (requeued with prompt+emitted, so nothing is lost), and
decode runs in chunks of up to ``scan_chunk`` steps back to back on the
device between host observations.  The scheduler and block allocator are
the port's own copies of the reference's (numpy only), so both packages
plan the same chunks.

The options of the reference engine served here: int8 K/V pools
(``kv_dtype``), prefix caching within and across calls (``prefix_cache``:
a warm pool persists between streams of one geometry), and greedy
speculative decoding (``spec_decode``: prompt-lookup drafts verified in one
chunk dispatch, rejected positions rolled back).  ``overlap`` and
``num_shards > 1`` are later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lora import lora_scale
from repro_torch.models.model import resolve_backend
from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed, reset_slot
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.scheduler import PRIORITY_CLASSES, Scheduler

Params = Any


@dataclasses.dataclass
class ServeConfig:
    batch_size: int                  # decode slots
    max_new_tokens: int = 32         # default per-request budget
    temperature: float = 0.0         # 0 => greedy
    seed: int = 0                    # seeds the sampling torch.Generator
    eos_id: Optional[int] = None     # a row that samples it stops
    block_size: int = 16             # paged-cache block size
    num_blocks: Optional[int] = None  # pool size; None => full residency
    max_blocks_per_slot: Optional[int] = None  # table width; None => span
    scan_chunk: int = 32             # max decode steps between admissions
    prefill_chunk: int = 16          # prompt tokens per prefill dispatch
    sched_policy: str = "sla"        # "sla" | "fcfs" (see scheduler.py)
    sched_aging: int = 16
    paged_backend: Optional[str] = None  # "cuda" | "torch"; None: by device
    kv_dtype: str = "f32"            # "int8": int8 K/V pools + fp32 scales
    prefix_cache: bool = False       # content-addressed shared blocks,
    #                                  within and across generate calls
    #                                  (greedy warm == cold, bitwise)
    spec_decode: bool = False        # greedy-only prompt-lookup drafts of
    #                                  up to spec_k tokens, verified in one
    #                                  chunk dispatch (== sequential greedy)
    spec_k: int = 4
    spec_ngram: int = 3              # longest history n-gram the drafter
    #                                  matches (see serving/spec_decode.py)
    # Options of the reference engine that later slices of the port serve
    # (ROADMAP.md).  Each raises NotImplementedError when set.
    num_shards: int = 1
    overlap: bool = False


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` (S,) int32 (ragged lengths are
    fine); ``max_new_tokens`` overrides the config's budget; ``priority``
    names a class (``interactive`` | ``batch`` | ``background``), falling
    back to the client's registered default, then ``"batch"``."""
    client_id: Any
    prompt: Any
    max_new_tokens: Optional[int] = None
    priority: Optional[str] = None
    deadline: Optional[float] = None


def _check_supported(sc: ServeConfig) -> None:
    later = [("num_shards > 1", sc.num_shards > 1,
              "sharded serving and hot-swap"),
             ("overlap=True", sc.overlap, "overlap/deferred observation")]
    for name, on, item in later:
        if on:
            raise NotImplementedError(
                f"ServeConfig {name} is not served by this slice of the "
                f"port (ROADMAP: {item})")
    if sc.spec_decode:
        if sc.temperature > 0:
            raise ValueError(
                "spec_decode is greedy-only (temperature must be 0): "
                "acceptance compares drafts against argmax tokens, which is "
                "what makes the stream equal to non-speculative decoding")
        if sc.spec_k < 1:
            raise ValueError(f"spec_decode needs spec_k >= 1, got "
                             f"{sc.spec_k}")
    if sc.kv_dtype not in ("f32", "int8"):
        raise ValueError(f"kv_dtype must be 'f32' or 'int8', got "
                         f"{sc.kv_dtype!r}")
    if sc.num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {sc.num_shards}")


class MultiTenantEngine:
    """One base model serving every registered client's adapter."""

    def __init__(self, model, cfg, params: Params, registry: AdapterRegistry):
        if registry.device != model.device:
            raise ValueError(f"registry bank on {registry.device} but model "
                             f"on {model.device}")
        self.model, self.cfg = model, cfg
        self.params, self.registry = params, registry
        self.device = model.device
        # alpha / cfg.lora_rank whatever the registry's ranks, as in the
        # reference: a client's rank is the shape of its factors, and the
        # scale is the model's
        self.scale = lora_scale(cfg)
        self.last_stats: Optional[dict] = None
        # cross-call prefix-cache state: (pool key, PagedKVCache, device
        # cache) kept at stream drain so the next stream's admission can
        # match blocks sealed by this one (the device pools stay resident
        # until release_prefix_cache or a stream of another geometry)
        self._warm: Optional[Tuple[tuple, PagedKVCache, Any]] = None

    def release_prefix_cache(self) -> None:
        """Drop the warm prefix-cache pool (host allocator and device K/V);
        the next ``prefix_cache=True`` stream starts cold."""
        self._warm = None

    def _paged_pool(self, key: tuple, sc: ServeConfig
                    ) -> Tuple[PagedKVCache, Any, bool]:
        """(host allocator, device cache, reused) for one stream of pool
        geometry ``key`` = (slots, block size, blocks, table width,
        kv_dtype).  With ``sc.prefix_cache`` the pair kept by the last
        drained stream is reused when its key matches and it is idle;
        otherwise the stream starts cold."""
        num_slots, _, num_blocks, blocks_per, _ = key
        if sc.prefix_cache:
            warm, self._warm = self._warm, None   # taken; restored at drain
            if warm is not None and warm[0] == key and warm[1].idle:
                return warm[1], warm[2], True
        kv = PagedKVCache(num_slots, sc.block_size, num_blocks, blocks_per,
                          prefix_cache=sc.prefix_cache)
        cache = self.model.init_paged_decode_cache(
            num_blocks, sc.block_size, kv_dtype=sc.kv_dtype)
        return kv, cache, False

    def bank_for(self, sc: ServeConfig):
        """The registry's bank in the layout the stream's backend reads:
        the kernel view on ``"cuda"`` (ragged buckets concatenated once per
        bank epoch), the per-bucket lists on ``"torch"``."""
        backend = resolve_backend(self.cfg, sc.paged_backend,
                                  self.device).paged_backend
        return (self.registry.kernel_bank() if backend == "cuda"
                else self.registry.bank())

    # -- device steps --------------------------------------------------------
    @staticmethod
    def _sample(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
        """(K, V) fp32 logits -> (K,) int32: argmax (first maximum on ties)
        at temperature 0, else a draw from softmax(logits / temperature)."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    def _prefill_chunk(self, bank, ids, cache, tokens, lengths, n_new,
                       block_tables, gen, temperature, backend):
        """One chunked-prefill dispatch; samples each row at its LAST valid
        position.  Returns ((K,) sampled, cache)."""
        logits, cache = self.model.prefill_step(
            self.params, cache, tokens, lengths, n_new, adapters=bank,
            lora_scale=self.scale, adapter_ids=ids,
            block_tables=block_tables, paged_backend=backend)
        K, T, _ = logits.shape
        rows = torch.arange(K, device=logits.device)
        last = torch.clamp(n_new.long() - 1, 0, T - 1)
        return self._sample(logits[rows, last], gen, temperature), cache

    def _verify_chunk(self, bank, ids, cache, tokens, lengths, n_new,
                      block_tables, backend):
        """One draft-verify dispatch: the prefill dataflow, with the greedy
        sample read at EVERY chunk position.  Returns ((K, T) int32,
        cache)."""
        logits, cache = self.model.verify_step(
            self.params, cache, tokens, lengths, n_new, adapters=bank,
            lora_scale=self.scale, adapter_ids=ids,
            block_tables=block_tables, paged_backend=backend)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _decode_chunk(self, bank, ids, cache, last, active, lengths,
                      block_tables, n_steps, gen, temperature, backend):
        """``n_steps`` decode steps, each slot feeding its last sample.
        Returns ((n_steps, K) sampled, cache)."""
        out = []
        for _ in range(n_steps):
            logits, cache = self.model.decode_step(
                self.params, cache, last[:, None], lengths, adapters=bank,
                lora_scale=self.scale, adapter_ids=ids,
                block_tables=block_tables, paged_backend=backend)
            last = self._sample(logits[:, 0], gen, temperature)
            out.append(last)
            lengths = lengths + active
        return torch.stack(out), cache

    # -- continuous batching -------------------------------------------------
    def session(self, sc: ServeConfig,
                requests: Optional[Sequence[Request]] = None
                ) -> "StreamSession":
        """A continuous-batching session; with ``requests=None`` it starts
        empty and callers :meth:`StreamSession.submit` between steps (the
        pool must then be pinned with ``sc.num_blocks``)."""
        return StreamSession(self, sc, requests)

    def generate_stream(self, requests: Sequence[Request], sc: ServeConfig
                        ) -> Iterator[Tuple[int, List[int], bool]]:
        """Yields ``(rid, new_tokens, finished)`` as each chunk is observed;
        ``rid`` is the request's index.  ``self.last_stats`` is set when the
        stream drains."""
        if not requests:
            raise ValueError("empty request batch")
        ses = StreamSession(self, sc, requests)
        while ses.has_work:
            yield from ses.step()
        ses.finalize()

    def generate(self, requests: Sequence[Request],
                 sc: ServeConfig) -> List[np.ndarray]:
        """One 1-D int32 array per request (request order), at most its
        budget long (an EOS-terminated row includes the EOS)."""
        outs: List[List[int]] = [[] for _ in requests]
        for rid, toks, _ in self.generate_stream(requests, sc):
            outs[rid].extend(toks)
        return [np.asarray(o, np.int32) for o in outs]


class StreamSession:
    """One continuous-batching session over a paged KV pool: ``submit`` a
    request at any time, ``step`` runs one round (admission -> chunk
    planning -> device dispatch -> observation) and returns its events,
    ``finalize`` builds ``engine.last_stats``.  Each round materialises its
    samples before the next is planned (the synchronous reference loop)."""

    def __init__(self, engine: MultiTenantEngine, sc: ServeConfig,
                 requests: Optional[Sequence[Request]] = None):
        _check_supported(sc)
        self.engine, self.sc = engine, sc
        self.open_loop = requests is None
        if self.open_loop:
            if sc.num_blocks is None:
                raise ValueError(
                    "an open-loop StreamSession needs ServeConfig."
                    "num_blocks pinned (pool geometry cannot follow "
                    "requests that have not arrived yet)")
            num_slots = max(1, sc.batch_size)
            num_blocks = sc.num_blocks
            blocks_per = sc.max_blocks_per_slot or (num_blocks - 1)
            T = max(1, sc.prefill_chunk)
        else:
            prompts = [np.asarray(r.prompt, np.int32).reshape(-1)
                       for r in requests]
            budgets = [sc.max_new_tokens if r.max_new_tokens is None
                       else r.max_new_tokens for r in requests]
            max_span = max(p.size + b for p, b in zip(prompts, budgets))
            if sc.prefix_cache and sc.num_blocks is not None:
                # stable geometry, so the warm pool survives batches of
                # other sizes: slots follow batch_size and the table spans
                # the whole pool unless pinned tighter
                num_slots = max(1, sc.batch_size)
                num_blocks = sc.num_blocks
                blocks_per = sc.max_blocks_per_slot or (num_blocks - 1)
            else:
                num_slots = max(1, min(sc.batch_size, len(requests)))
                blocks_per = (sc.max_blocks_per_slot
                              or blocks_needed(max_span, sc.block_size))
                num_blocks = sc.num_blocks or (1 + num_slots * blocks_per)
            # preemption replays prompt+emitted, so the chunk width must fit
            # the longest possible replay; fixed per run
            T = max(1, min(sc.prefill_chunk, max_span - 1))
        dev = engine.device
        self._geom_key = (num_slots, sc.block_size, num_blocks, blocks_per,
                          sc.kv_dtype)
        self.kv, self.cache, self._reused = engine._paged_pool(
            self._geom_key, sc)
        self._evicted0 = self.kv.evicted_cached   # pool-lifetime counter
        self.sched = Scheduler(self.kv, policy=sc.sched_policy,
                               aging_ticks=sc.sched_aging,
                               spec_k=sc.spec_k if sc.spec_decode else 0,
                               spec_ngram=sc.spec_ngram)
        self._next_rid = 0
        if not self.open_loop:
            for r in requests:
                self.submit(r)
        self.bank = engine.bank_for(sc)
        # a registration moves bank_epoch; step() re-snapshots the bank at
        # its next round (the ragged kernel view is rebuilt per epoch)
        self._bank_epoch = engine.registry.bank_epoch
        self.bank_refreshes = 0
        self.ids = np.zeros((num_slots,), np.int32)
        self.gen = torch.Generator(device=dev).manual_seed(sc.seed)
        engine.last_stats = None
        self.T = T
        # verify chunks have their own fixed width: the drafts + feedback
        self.Tv = 1 + sc.spec_k
        # EOS can end a row long before its budget; keep chunks short so
        # its slot frees (and admits the queue head) at the next boundary
        self.cap = (min(sc.scan_chunk, 8) if sc.eos_id is not None
                    else sc.scan_chunk)
        self._finalized = False

    # -- intake --------------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Enqueue ``request``; returns its rid (submission order)."""
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        reg = self.engine.registry
        p = np.asarray(request.prompt, np.int32).reshape(-1)
        b = (self.sc.max_new_tokens if request.max_new_tokens is None
             else request.max_new_tokens)
        scope = (request.client_id, reg.version(request.client_id))
        priority = (request.priority
                    or reg.default_priority(request.client_id)
                    or "batch")
        self.sched.submit(rid, request.client_id, p, b, scope=scope,
                          priority=priority, deadline=request.deadline)
        return rid

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # -- one engine round ----------------------------------------------------
    def step(self) -> List[Tuple[int, List[int], bool]]:
        """Admission -> chunk planning -> dispatch -> observation.  Raises
        ``RuntimeError`` if queued work cannot make progress."""
        eng, sc, sched = self.engine, self.sc, self.sched
        dev = eng.device
        if eng.registry.bank_epoch != self._bank_epoch:
            self.bank = eng.bank_for(sc)
            self._bank_epoch = eng.registry.bank_epoch
            self.bank_refreshes += 1
        for slot, cid in sched.admit():
            self.ids[slot] = eng.registry.acquire(cid)
            self.cache = reset_slot(self.cache, slot)
        plan = sched.prepare_chunk(self.T, self.cap)
        if plan is None:
            if sched.has_work:
                raise RuntimeError("scheduler stalled with queued work")
            return []
        bt, lens = self.kv.device_tables(dev)
        ids = torch.tensor(self.ids, dtype=torch.int32, device=dev)
        if plan[0] == "prefill":
            arrs = sched.prefill_arrays(self.T)
            n_new = torch.tensor(arrs["n_new"], device=dev)
            sampled, self.cache = eng._prefill_chunk(
                self.bank, ids, self.cache,
                torch.tensor(arrs["tokens"], device=dev), lens, n_new, bt,
                self.gen, sc.temperature, sc.paged_backend)
            return sched.observe_prefill(arrs["n_new"], sampled.cpu().numpy(),
                                         eos_id=sc.eos_id)
        if plan[0] == "verify":
            arrs = sched.verify_arrays(self.Tv)
            greedy, self.cache = eng._verify_chunk(
                self.bank, ids, self.cache,
                torch.tensor(arrs["tokens"], device=dev), lens,
                torch.tensor(arrs["n_new"], device=dev), bt, sc.paged_backend)
            return sched.observe_verify(arrs["n_new"], greedy.cpu().numpy(),
                                        eos_id=sc.eos_id)
        n = plan[1]
        st = sched.chunk_arrays()
        out, self.cache = eng._decode_chunk(
            self.bank, ids, self.cache,
            torch.tensor(st["last"], device=dev),
            torch.tensor(st["active"], device=dev), lens, bt, n, self.gen,
            sc.temperature, sc.paged_backend)
        return sched.observe_chunk(out.cpu().numpy(), eos_id=sc.eos_id)

    # -- drain ---------------------------------------------------------------
    def finalize(self) -> dict:
        """Build ``engine.last_stats`` for this session (idempotent)."""
        if self._finalized:
            return self.engine.last_stats
        self._finalized = True
        sc, sched, kv = self.sc, self.sched, self.kv
        classes = {}
        for cname in PRIORITY_CLASSES:
            waits = sched.wait_ticks.get(cname, [])
            if not waits and cname not in sched.preemptions_by_class:
                continue
            classes[cname] = {
                "admitted": len(waits),
                "wait_p50": float(np.percentile(waits, 50)) if waits else 0.0,
                "wait_p99": float(np.percentile(waits, 99)) if waits else 0.0,
                "preemptions": sched.preemptions_by_class.get(cname, 0)}
        stats = {"prefill_dispatches": sched.prefill_dispatches,
                 "decode_dispatches": sched.decode_dispatches,
                 "decode_steps": sched.steps,
                 "spec_decode": sc.spec_decode,
                 "verify_dispatches": sched.verify_dispatches,
                 "drafted_tokens": sched.drafted_tokens,
                 "accepted_tokens": sched.accepted_tokens,
                 "acceptance_rate": (sched.accepted_tokens
                                     / max(1, sched.drafted_tokens)),
                 "rollback_tokens": sched.rollback_tokens,
                 "rollback_blocks": sched.rollback_blocks,
                 "preemptions": sched.preemptions,
                 "prompt_tokens": sched.prompt_tokens,
                 "prefix_hit_tokens": sched.prefix_hit_tokens,
                 "prefix_hit_rate": (sched.prefix_hit_tokens
                                     / max(1, sched.prompt_tokens)),
                 "prefix_cached_blocks": kv.cached_blocks,
                 "prefix_evictions": kv.evicted_cached - self._evicted0,
                 "prefix_pool_reused": self._reused,
                 "adapter_bank_refreshes": self.bank_refreshes,
                 "sched_policy": sc.sched_policy,
                 "num_shards": sc.num_shards,
                 "kv_dtype": sc.kv_dtype,
                 "overlap": sc.overlap,
                 "paged_backend": sc.paged_backend,
                 "open_loop": self.open_loop,
                 "classes": classes,
                 "victim_sealed_fraction_mean": (
                     float(np.mean(sched.victim_sealed_fractions))
                     if sched.victim_sealed_fractions else 0.0)}
        self.engine.last_stats = stats
        if sc.prefix_cache:
            self.engine._warm = (self._geom_key, self.kv, self.cache)
        return stats

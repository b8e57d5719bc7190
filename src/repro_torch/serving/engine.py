"""Serving engines: continuous batching over a paged KV pool, and the
fixed-batch path.

Port of ``repro/serving/engine.py``.  Two engines share one fixed-batch
generation loop (:meth:`_EngineBase._run`: sequential prefill through the
decode step into a contiguous ring-buffer cache, then decode; EOS rows pad
with ``pad_id``):

  * :class:`Engine` — single tenant: one adapter tree (or none) bound at
    construction; on the card its projections run the single-pair LoRA
    kernel.
  * :class:`MultiTenantEngine` — one base model and an
    :class:`~repro_torch.serving.registry.AdapterRegistry` bank (or its
    sharded form, ``serving/sharded.py``); each batch row is routed to its
    client's bank slot through per-row ``adapter_ids``.  ``generate`` is
    continuous batching (:class:`StreamSession`); ``generate_fixed`` keeps
    the fixed-shape path for equal-length prompts with one shared budget.

In :class:`StreamSession` ragged prompts are fed by CHUNKED prefill
dispatches, blocks are allocated on demand, a victim is preempted when the
pool runs dry (requeued with prompt+emitted, so nothing is lost), and
decode runs in chunks of up to ``scan_chunk`` steps back to back on the
device between host observations.  The scheduler and block allocator are
the port's own copies of the reference's (numpy only), so both packages
plan the same chunks.

A model with mamba layers keeps their recurrent state per slot next to
the K/V pools (zeroed when a slot admits a request); the fixed path keeps
it per batch row.

The options of the reference engine served here: int8 K/V pools
(``kv_dtype``), prefix caching within and across calls (``prefix_cache``:
a warm pool persists between streams of one geometry), greedy speculative
decoding (``spec_decode``: prompt-lookup drafts verified in one chunk
dispatch, rejected positions rolled back; these two need an
attention-only model, as in the reference), overlapped dispatch
(``overlap``, the default: see :class:`StreamSession`) and sharded serving
(``num_shards``: the pool, the slots and, with a
:class:`~repro_torch.serving.sharded.ShardedAdapterRegistry`, the bank
split into placement domains, still one dispatch per round).

``ServeConfig.mesh`` (a ``("pod", "data", "model")`` ``DeviceMesh`` from
``launch/mesh.make_mesh``; dense, MoE, SSM and hybrid configs) serves
one stream on every rank of the mesh, each rank's process running this
same code: every rank plans every slot (scheduler, pool, prefix index,
drafts), and dispatches its part.  Slots lie on "data" (rank r of D
serves its shard-contiguous block of slots, with a device pool of
scratch block 0 and its shards' blocks, and its slots' rows of a mamba
layer's recurrent state, zeroed on admission at ``slot - lo``), heads,
ff columns and the vocabulary on "model" (each rank holds its shard of
the base, of the bank and of the pools' kv heads, its block of an MoE
layer's experts, and its SSM heads of a mamba layer's weights and
state; ``models/tensor_parallel.py``), and "pod" replicates, as the
reference's ``P("data")`` on the fused batch does.  Every rank samples
the same tokens: greedy through the vocabulary-parallel argmax, sampling
from the rows' whole logits and the meshless stream's (K, V) draws; one
all-gather over "data" then gives each rank the whole batch's tokens, so
the host planning stays identical on every rank and the streams are the
meshless ones (bitwise where the ranks' products round as one card's
do).  An MoE layer over "data" gathers every rank's routing ids (one
all-gather a layer and dispatch), so each expert's capacity and slots
are the whole fused batch's, as the meshless dispatch's, and each
attention layer syncs the pools' scratch block, whose contents the
ragged tails that MoE routes read (``layers.sync_scratch``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lora import lora_scale
from repro_torch.core.partition import mesh_coordinate, mesh_shape
from repro_torch.federated.distributed import local_shard
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.model import resolve_backend
from repro_torch.serving.kv_cache import (PagedKVCache, blocks_needed,
                                          reset_slot, to_device)
from repro_torch.serving.registry import AdapterRegistry, model_shard
from repro_torch.serving.scheduler import PRIORITY_CLASSES, Scheduler
from repro_torch.serving.sharded import ShardedPagedKVCache, ShardedScheduler

Params = Any


@dataclasses.dataclass
class ServeConfig:
    batch_size: int                  # decode slots (continuous) / batch rows
    max_new_tokens: int = 32         # default per-request budget
    cache_len: int = 4096            # fixed-path cache length (the window
    #                                  for sliding-window archs)
    temperature: float = 0.0         # 0 => greedy
    seed: int = 0                    # seeds the sampling torch.Generator
    eos_id: Optional[int] = None     # a row that samples it stops (fixed
    #                                  path: emits pad_id afterwards)
    pad_id: int = 0
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
    overlap: bool = True             # plan and enqueue chunk N+1 while
    #                                  the card runs chunk N; samples are
    #                                  read back only when the next plan
    #                                  needs them (StreamSession).  False:
    #                                  the synchronous loop.  Both run the
    #                                  same dispatches on the same inputs,
    #                                  so streams are bitwise equal
    num_shards: int = 1              # split the block pool and the slots
    #                                  into this many shards
    #                                  (serving/sharded.py): per-shard free
    #                                  lists, seal chains and preemption,
    #                                  placement-aware admission, one fused
    #                                  dispatch per round; streams equal the
    #                                  single pool's, bitwise
    mesh: Any = None                 # a ("pod", "data", "model")
    #                                  DeviceMesh (launch/mesh.make_mesh):
    #                                  slots over "data" (num_shards a
    #                                  multiple of its size), heads, ff
    #                                  columns and vocabulary over "model",
    #                                  "pod" replicated; every rank runs the
    #                                  same stream.  None: one device


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
    if sc.num_shards > 1 and sc.batch_size % sc.num_shards != 0:
        raise ValueError(
            f"batch_size {sc.batch_size} not divisible by {sc.num_shards} "
            f"shards (slots split evenly)")
    data = 1 if sc.mesh is None else mesh_shape(sc.mesh).get("data", 1)
    if sc.num_shards % data:
        raise ValueError(
            f"num_shards {sc.num_shards} is not a multiple of the mesh's "
            f"\"data\" axis {data}: each data rank serves whole shards")


def check_serve_mesh(cfg, mesh) -> None:
    """Refuse, naming why, a config ``ServeConfig.mesh`` cannot serve:
    at "model" > 1 a split count that does not divide
    (``tensor_parallel.check_model_axis``; a vocabulary the axis does not
    divide is whole on every rank, not refused).  At "data" > 1 every
    family serves: a mamba layer's recurrent state is per slot, so each
    data rank holds its slots' rows.  The VLM serves text-only requests,
    as it does meshless; the encoder-decoder stays outside the paged
    engine, refused by the meshless engine's own check, as the
    reference's is."""
    tpl.check_model_axis(cfg, mesh_shape(mesh).get("model", 1))


class _MeshRank:
    """One rank's part of a stream over ``ServeConfig.mesh``: its rows
    (slots ``[lo, hi)``, shard-contiguous), its shards of the pool and its
    device pool's size, its model group, its data group (which an MoE
    layer's dispatch spans), and the sampling every rank agrees on, over
    the vocabulary's blocks where the model group splits ``cfg``'s
    vocabulary and over the whole logits where it does not
    (``tensor_parallel.vocab_split``)."""

    def __init__(self, cfg, mesh, num_slots: int, num_blocks: int,
                 num_shards: int):
        sizes, coord = mesh_shape(mesh), mesh_coordinate(mesh)
        self.mesh = mesh
        self.data = sizes.get("data", 1)
        d = coord.get("data", 0)
        self.num_slots = num_slots
        rows = num_slots // self.data
        self.lo, self.hi = d * rows, (d + 1) * rows
        per = num_shards // self.data
        self.shards = range(d * per, (d + 1) * per)
        self.num_blocks = 1 + per * ((num_blocks - 1) // num_shards)
        self.tp = mesh_lib.model_group(mesh)
        self.dp = mesh_lib.data_group(mesh)
        self.split = (self.tp is not None
                      and tpl.vocab_split(cfg, self.tp.size))
        self.key = (tuple(sizes.items()), tuple(coord.items()))
        self.params = None            # the engine's params_for(mesh)

    def rows(self, arr):
        """This rank's rows of a per-slot host array."""
        return arr[self.lo:self.hi]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t`` (its leading dim), in slot
        order: one all-gather over "data"."""
        if self.data == 1:
            return t
        g = mesh_lib.all_gather(t, self.mesh, "data")
        return g.reshape(-1, *t.shape[1:])

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """int32 argmax of this rank's rows' logits (..., V / size), or
        of the whole logits (..., V) where the vocabulary is whole."""
        if not self.split:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return tpl.vocab_parallel_greedy(logits, self.tp).to(torch.int32)

    def sample(self, logits: torch.Tensor, gen: torch.Generator,
               temperature: float) -> torch.Tensor:
        """(K_rank, V / size) fp32 logits (or (K_rank, V) where the
        vocabulary is whole) -> every slot's (K,) int32 sample, the same
        on every rank and the meshless stream's: greedy as
        :meth:`greedy`; else the rows' whole logits (gathered over
        "model" where it splits them) and their rows of the meshless (K,
        V) Exp(1) draws (every rank draws them all, so the generators
        stay in step)."""
        if temperature <= 0:
            return self.gather(self.greedy(logits))
        if self.split:
            g = mesh_lib.all_gather(logits.contiguous(), self.mesh, "model")
            logits = g.permute(1, 0, 2).reshape(logits.shape[0], -1)
        probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
        noise = torch.empty((self.num_slots, probs.shape[-1]),
                            dtype=probs.dtype,
                            device=probs.device).exponential_(1,
                                                              generator=gen)
        tok = torch.argmax(probs / noise[self.lo:self.hi], dim=-1)
        return self.gather(tok.to(torch.int32))


def _no_fixed_mesh(sc: ServeConfig) -> None:
    if sc.mesh is not None:
        raise ValueError("the fixed-batch path (Engine.generate, "
                         "generate_fixed) over ServeConfig.mesh is not "
                         "ported; generate and generate_stream serve there")


class _EngineBase:
    """The fixed-batch generation loop, parameterised by optional per-row
    adapter ids."""

    def __init__(self, model, cfg):
        self.model, self.cfg = model, cfg
        self.device = model.device
        # alpha / cfg.lora_rank whatever the registry's ranks, as in the
        # reference: a client's rank is the shape of its factors, and the
        # scale is the model's
        self.scale = lora_scale(cfg)

    @staticmethod
    def _sample(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
        """(K, V) fp32 logits -> (K,) int32: argmax (first maximum on ties)
        at temperature 0, else a draw from softmax(logits / temperature):
        argmax(p / E) with E ~ Exp(1), which is ``torch.multinomial``'s own
        one-sample path (same draws from ``gen``) without its host-side
        checks of ``p``, each of which waits for the card."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
        noise = torch.empty_like(probs).exponential_(1, generator=gen)
        return torch.argmax(probs / noise, dim=-1).to(torch.int32)

    def _prefill(self, params, adapters, ids, cache, prompts: torch.Tensor,
                 backend: Optional[str]):
        """Sequential prefill through the decode step (one position per
        step, as in the reference).  Returns (cache, tokens fed, logits
        (B, V) at the last prompt position)."""
        logits = None
        for t in range(prompts.shape[1]):
            logits, cache = self.model.decode_step(
                params, cache, prompts[:, t:t + 1], t, adapters=adapters,
                lora_scale=self.scale, adapter_ids=ids,
                paged_backend=backend)
        return cache, prompts.shape[1], logits[:, 0]

    def _run(self, params, adapters, ids, prompts, sc: ServeConfig
             ) -> torch.Tensor:
        """prompts (B, S) int32 -> (B, max_new_tokens) int32 on the
        engine's device.  The first token is the argmax of the last prompt
        position's logits (as in the reference), later ones are sampled at
        ``sc.temperature`` from a generator seeded by ``sc.seed``.  With
        ``sc.eos_id`` a row that samples EOS emits ``sc.pad_id`` from then
        on, and the loop exits once every row has finished (the output
        stays (B, max_new_tokens), pad-filled).  ``sc.paged_backend``
        picks the projections' path ("cuda" kernels or "torch"); attention
        over the ring-buffer cache is the plain path either way."""
        dev = self.device
        prompts = to_device(np.asarray(prompts, np.int32), dev)
        B = prompts.shape[0]
        cache = self.model.init_decode_cache(B, sc.cache_len)
        cache, pos, last = self._prefill(params, adapters, ids, cache,
                                         prompts, sc.paged_backend)
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        gen = torch.Generator(device=dev).manual_seed(sc.seed)
        out = [tok]
        finished = (tok == sc.eos_id) if sc.eos_id is not None else None
        for _ in range(sc.max_new_tokens - 1):
            if finished is not None and bool(finished.all()):
                break                         # reads back: EOS runs only
            logits, cache = self.model.decode_step(
                params, cache, tok[:, None], pos, adapters=adapters,
                lora_scale=self.scale, adapter_ids=ids,
                paged_backend=sc.paged_backend)
            nxt = self._sample(logits[:, 0], gen, sc.temperature)
            if finished is not None:
                nxt = torch.where(finished, torch.full_like(nxt, sc.pad_id),
                                  nxt)
                finished = finished | (nxt == sc.eos_id)
            pos += 1
            tok = nxt
            out.append(nxt)
        res = torch.stack(out, dim=1)
        if res.shape[1] < sc.max_new_tokens:           # early all-EOS exit
            pad = torch.full((B, sc.max_new_tokens - res.shape[1]),
                             sc.pad_id, dtype=torch.int32, device=dev)
            res = torch.cat([res, pad], dim=1)
        return res


class Engine(_EngineBase):
    """Single-tenant engine: one adapter tree (or None: the base model)
    bound per instance."""

    def __init__(self, model, cfg, params: Params,
                 adapters: Optional[Params] = None):
        super().__init__(model, cfg)
        self.params, self.adapters = params, adapters

    def generate(self, prompts, sc: ServeConfig) -> torch.Tensor:
        """prompts (B, S) int32 -> (B, max_new_tokens) int32."""
        _no_fixed_mesh(sc)
        return self._run(self.params, self.adapters, None, prompts, sc)


class MultiTenantEngine(_EngineBase):
    """One base model serving every registered client's adapter."""

    def __init__(self, model, cfg, params: Params, registry: AdapterRegistry):
        if registry.device != model.device:
            raise ValueError(f"registry bank on {registry.device} but model "
                             f"on {model.device}")
        super().__init__(model, cfg)
        self.params, self.registry = params, registry
        self.last_stats: Optional[dict] = None
        # cross-call prefix-cache state: (pool key, PagedKVCache, device
        # cache) kept at stream drain so the next stream's admission can
        # match blocks sealed by this one (the device pools stay resident
        # until release_prefix_cache or a stream of another geometry)
        self._warm: Optional[Tuple[tuple, PagedKVCache, Any]] = None
        # a model rank's shards of the base (per mesh) and of the bank
        # (per mesh, bank epoch and layout), taken once each
        self._params_shard: Optional[Tuple[tuple, Params]] = None
        self._bank_shard: Optional[Tuple[tuple, Params]] = None

    def release_prefix_cache(self) -> None:
        """Drop the warm prefix-cache pool (host allocator and device K/V);
        the next ``prefix_cache=True`` stream starts cold."""
        self._warm = None

    def _paged_pool(self, key: tuple, sc: ServeConfig,
                    rk: Optional[_MeshRank] = None
                    ) -> Tuple[Any, Any, bool]:
        """(host allocator, device cache, reused) for one stream of pool
        geometry ``key`` = (slots, block size, blocks, table width, shards,
        kv_dtype, mesh rank).  With ``sc.prefix_cache`` the pair kept by
        the last drained stream is reused when its key matches (the shard
        count included: a single pool's tables are not a sharded pool's)
        and it is idle; otherwise the stream starts cold.  Over a mesh the
        device cache is the rank's: its shards' blocks, its slots' state
        and its kv heads."""
        num_slots, _, num_blocks, blocks_per, num_shards = key[:5]
        if sc.prefix_cache:
            warm, self._warm = self._warm, None   # taken; restored at drain
            if warm is not None and warm[0] == key and warm[1].idle:
                return warm[1], warm[2], True
        if num_shards > 1:
            kv: Any = ShardedPagedKVCache(num_shards, num_slots,
                                          sc.block_size, num_blocks,
                                          blocks_per,
                                          prefix_cache=sc.prefix_cache)
        else:
            kv = PagedKVCache(num_slots, sc.block_size, num_blocks,
                              blocks_per, prefix_cache=sc.prefix_cache)
        if rk is not None:
            num_blocks, num_slots = rk.num_blocks, rk.hi - rk.lo
        cache = self.model.init_paged_decode_cache(
            num_blocks, sc.block_size, kv_dtype=sc.kv_dtype,
            num_slots=num_slots, tp=None if rk is None else rk.tp)
        if sc.prefix_cache or sc.spec_decode:
            # recurrent SSM state is per slot and dense: it cannot be
            # rebuilt from cached K/V blocks (a prefix hit would skip state
            # updates) nor rolled back a token at a time (a verify dispatch
            # advances it through rejected drafts)
            feature = "prefix_cache" if sc.prefix_cache else "spec_decode"
            for entry in cache["layers"]:
                extra = set(entry) - {"k_pool", "v_pool", "k_scale",
                                      "v_scale"}
                if extra:
                    raise ValueError(
                        f"{feature}=True needs an attention-only model: "
                        f"recurrent per-slot state {sorted(extra)} cannot "
                        "be block-cached or rolled back")
        return kv, cache, False

    def bank_for(self, sc: ServeConfig):
        """The registry's bank in the layout the stream's backend reads:
        the kernel view on ``"cuda"`` (ragged buckets, or a sharded
        registry's global order, concatenated once per bank epoch), the
        per-bucket lists on ``"torch"``.  Over a mesh whose "model" axis
        is > 1: this rank's shard of it (``registry.model_shard``), taken
        once per bank epoch."""
        backend = resolve_backend(self.cfg, sc.paged_backend,
                                  self.device).paged_backend
        bank = (self.registry.kernel_bank() if backend == "cuda"
                else self.registry.bank())
        tp = None if sc.mesh is None else mesh_lib.model_group(sc.mesh)
        if tp is None:
            return bank
        key = (self.registry.bank_epoch, backend, tp.size, tp.rank)
        if self._bank_shard is None or self._bank_shard[0] != key:
            self._bank_shard = None       # the old shard's memory first
            self._bank_shard = (key, model_shard(bank, self.cfg, tp.size,
                                                 tp.rank))
        return self._bank_shard[1]

    def hold_shard(self, size: int, rank: int, params: Params) -> None:
        """Serve ``params``, the base's shard at rank ``rank`` of a
        ``size``-way "model" axis (``Model.init(shard=)``: drawn so, with
        no whole base ever held), and drop the whole base."""
        self.params = None
        self._params_shard = ((size, rank), params)

    def params_for(self, sc: ServeConfig) -> Params:
        """The base as the stream's ranks hold it: whole, or over a mesh
        whose "model" axis is > 1 this rank's ``local_shard`` under
        ``param_specs`` (taken once per mesh, or held from the start:
        :meth:`hold_shard`)."""
        tp = None if sc.mesh is None else mesh_lib.model_group(sc.mesh)
        if tp is None:
            if self.params is None:
                raise ValueError("the engine holds a model shard only; "
                                 "serve it over its mesh")
            return self.params
        key = (tp.size, tp.rank)
        if self._params_shard is None or self._params_shard[0] != key:
            if self.params is None:
                raise ValueError(f"the engine holds no whole base to cut "
                                 f"the shard {key} from")
            self._params_shard = None
            self._params_shard = (key, local_shard(
                self.params, self.model.param_specs(), sc.mesh))
        return self._params_shard[1]

    # -- device steps --------------------------------------------------------
    # Each takes its rows' inputs (a mesh rank's ``rk``: its slots, on its
    # shards of base, bank and pools) and returns every slot's samples.

    def _step_kw(self, bank, ids, block_tables, backend, rk):
        return {"adapters": bank, "lora_scale": self.scale,
                "adapter_ids": ids, "block_tables": block_tables,
                "paged_backend": backend,
                "tp": None if rk is None else rk.tp,
                "dp": None if rk is None else rk.dp}

    def _params(self, rk):
        return self.params if rk is None else rk.params

    def _sample_all(self, logits, gen, temperature, rk):
        if rk is None:
            return self._sample(logits, gen, temperature)
        return rk.sample(logits, gen, temperature)

    def _prefill_chunk(self, bank, ids, cache, tokens, lengths, n_new,
                       block_tables, gen, temperature, backend, rk=None):
        """One chunked-prefill dispatch; samples each row at its LAST valid
        position.  Returns ((K,) sampled, cache, lengths + n_new): the
        lengths on the card, as the host pool's ``advance`` leaves them."""
        logits, cache = self.model.prefill_step(
            self._params(rk), cache, tokens, lengths, n_new,
            **self._step_kw(bank, ids, block_tables, backend, rk))
        K, T, _ = logits.shape
        rows = torch.arange(K, device=logits.device)
        last = torch.clamp(n_new.long() - 1, 0, T - 1)
        return (self._sample_all(logits[rows, last], gen, temperature, rk),
                cache, lengths + n_new)

    def _verify_chunk(self, bank, ids, cache, tokens, lengths, n_new,
                      block_tables, backend, rk=None):
        """One draft-verify dispatch: the prefill dataflow, with the greedy
        sample read at EVERY chunk position.  Returns ((K, T) int32,
        cache)."""
        logits, cache = self.model.verify_step(
            self._params(rk), cache, tokens, lengths, n_new,
            **self._step_kw(bank, ids, block_tables, backend, rk))
        if rk is None:
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return rk.gather(rk.greedy(logits)), cache

    def _decode_chunk(self, bank, ids, cache, last, active, lengths,
                      block_tables, n_steps, gen, temperature, backend,
                      rk=None):
        """``n_steps`` decode steps, each slot feeding its last sample.
        Returns ((n_steps, K) sampled, cache, each slot's final length
        ``lengths + n_steps * active``, each slot's final sample): the last
        two on the card (a mesh rank's rows), the feed of a next chunk that
        is dispatched before this one is read back (garbage for inactive
        rows, whose writes sink into scratch block 0)."""
        out = []
        kw = self._step_kw(bank, ids, block_tables, backend, rk)
        for _ in range(n_steps):
            logits, cache = self.model.decode_step(
                self._params(rk), cache, last[:, None], lengths, **kw)
            every = self._sample_all(logits[:, 0], gen, temperature, rk)
            out.append(every)
            last = every if rk is None else every[rk.lo:rk.hi]
            lengths = lengths + active
        return torch.stack(out), cache, lengths, last

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

    # -- fixed-shape batch ---------------------------------------------------
    def generate_fixed(self, requests: Sequence[Request],
                       sc: ServeConfig) -> torch.Tensor:
        """B equal-length prompts (any mix of clients) -> (B,
        max_new_tokens) int32, row-aligned with ``requests``; every row
        decodes the shared ``sc.max_new_tokens`` budget over the
        registry's bank."""
        if not requests:
            raise ValueError("empty request batch")
        _no_fixed_mesh(sc)
        ids = to_device(np.asarray([self.registry.acquire(r.client_id)
                                    for r in requests], np.int32),
                        self.device)
        prompts = np.stack([np.asarray(r.prompt, np.int32).reshape(-1)
                            for r in requests])
        return self._run(self.params, self.bank_for(sc), ids, prompts, sc)


class _Readback:
    """A device tensor's values on their way to the host.  On a card the
    copy goes into pinned memory with ``non_blocking=True`` and an event is
    recorded behind it, so :meth:`numpy` waits for this copy (and the
    kernels before it) only, never for chunks enqueued after it: a plain
    ``.cpu()`` issued after chunk N+1 was enqueued would wait for N+1 too.
    On the CPU the tensor is already computed."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            t = host
        self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class StreamSession:
    """One continuous-batching session over a paged KV pool: ``submit`` a
    request at any time, ``step`` runs one round (admission -> chunk
    planning -> device dispatch -> observation) and returns its events,
    ``finalize`` builds ``engine.last_stats``.

    **Overlapped dispatch** (``ServeConfig.overlap``, the default), as in
    the reference: the host reads a chunk's samples back only when the
    next plan can depend on them.  A prefill chunk that feeds prompt tokens
    only emits nothing (``Scheduler.chunk_emits``) and is never read back,
    so the host plans and enqueues the next chunk while the card runs this
    one.  A decode chunk after which no slot can finish
    (``Scheduler.chunk_defer_safe``; no EOS, spec decode, prefix cache or
    shards configured) advances its counts at once (``observe_chunk_counts``);
    the next round dispatches the next chunk from state chained on the
    card (final samples, lengths, cached tables and ids) and only then
    reads this one back (``observe_chunk_values``): one-round-deferred
    observation, its events one round late.  Host arrays reach the card
    through pinned snapshots (:func:`to_device`) and samples come back
    through :class:`_Readback`, so no round waits for the stream but at
    the readbacks it needs.  Both settings run the same dispatches on the
    same inputs and draw from the generator in the same order, so streams
    are bitwise equal; ``overlap=False`` is the synchronous loop (one
    readback per chunk, tables and lengths sent every round).

    Everything runs on PyTorch's current stream, in order: a registration
    that rewrites bank slots in place between a deferred chunk's dispatch
    and its readback is ordered behind that chunk (a sharded registry's
    next bank is a new concatenation, so the old snapshot stays as it
    was).

    With ``num_shards > 1`` the pool is a
    :class:`~repro_torch.serving.sharded.ShardedPagedKVCache` and a
    :class:`~repro_torch.serving.sharded.ShardedScheduler` places each
    request on a shard; the rounds stay one dispatch each over all slots,
    so streams equal the single pool's.

    With ``sc.mesh`` every rank runs the session: the host state is every
    slot's on every rank, and each dispatch sends the rank's rows (its
    tables with block ids local to its pool, lengths, ids, feeds) and
    returns every slot's samples (``_MeshRank``).  An open-loop session is
    refused there: ranks admitting by their own wall clocks would plan
    different chunks."""

    def __init__(self, engine: MultiTenantEngine, sc: ServeConfig,
                 requests: Optional[Sequence[Request]] = None):
        _check_supported(sc)
        self.engine, self.sc = engine, sc
        self.open_loop = requests is None
        if sc.mesh is not None:
            check_serve_mesh(engine.cfg, sc.mesh)
            if self.open_loop:
                raise ValueError(
                    "an open-loop StreamSession over ServeConfig.mesh is "
                    "not ported: the ranks would admit by their own wall "
                    "clocks and plan different chunks; serve closed batches "
                    "(generate, generate_stream, session(sc, requests))")
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
                if sc.num_shards > 1:        # equal per-shard slot counts
                    num_slots = (-(-num_slots // sc.num_shards)
                                 * sc.num_shards)
                blocks_per = (sc.max_blocks_per_slot
                              or blocks_needed(max_span, sc.block_size))
                num_blocks = sc.num_blocks or (1 + num_slots * blocks_per)
            # preemption replays prompt+emitted, so the chunk width must fit
            # the longest possible replay; fixed per run
            T = max(1, min(sc.prefill_chunk, max_span - 1))
        if sc.num_shards > 1 and (num_blocks - 1) % sc.num_shards != 0:
            raise ValueError(
                f"allocatable blocks {num_blocks - 1} not divisible by "
                f"{sc.num_shards} shards (set num_blocks = 1 + "
                f"{sc.num_shards}*k)")
        dev = engine.device
        self.rk: Optional[_MeshRank] = None
        if sc.mesh is not None:
            self.rk = _MeshRank(engine.cfg, sc.mesh, num_slots, num_blocks,
                                sc.num_shards)
            self.rk.params = engine.params_for(sc)
        self._geom_key = (num_slots, sc.block_size, num_blocks, blocks_per,
                          sc.num_shards, sc.kv_dtype,
                          None if self.rk is None else self.rk.key)
        self.kv, self.cache, self._reused = engine._paged_pool(
            self._geom_key, sc, self.rk)
        self._evicted0 = self.kv.evicted_cached   # pool-lifetime counter
        spec_k = sc.spec_k if sc.spec_decode else 0
        if sc.num_shards > 1:
            self.sched: Any = ShardedScheduler(
                self.kv, registry=engine.registry, policy=sc.sched_policy,
                aging_ticks=sc.sched_aging, spec_k=spec_k,
                spec_ngram=sc.spec_ngram)
        else:
            self.sched = Scheduler(self.kv, policy=sc.sched_policy,
                                   aging_ticks=sc.sched_aging, spec_k=spec_k,
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
        # plan state on the card.  Tables are sent again only when
        # ``kv.table_version`` moves (admission, growth, rollback,
        # release); lengths chain from the previous dispatch's output and
        # are sent again after a verify round, whose advance and rollback
        # the host decides; ids are sent again after an admission
        self._tables_ver = -1
        self._bt_dev = self._lens_dev = self._ids_dev = None
        self._lens_ok = False
        # decode chaining: the next decode chunk feeds this one's final
        # samples and active mask, valid while the tables stand
        self._last_dev = self._act_dev = None
        self._last_ok = False
        # the deferred decode chunk: (readback, steps, slots)
        self._pending: Optional[Tuple[_Readback, int, List[int]]] = None
        # deferral reads no token value before the next plan: EOS and the
        # drafter read values to stop or draft, and prefix sealing hashes
        # them in ``advance``; the sharded scheduler does not split
        # observation into counts and values (as in the reference)
        self._defer_cfg_ok = (sc.overlap and sc.num_shards == 1
                              and sc.eos_id is None and not sc.spec_decode
                              and not sc.prefix_cache)
        self.deferred_chunks = 0          # decode chunks observed late
        self._finalized = False

    # -- intake --------------------------------------------------------------
    def submit(self, request: Request,
               arrival_time: Optional[float] = None) -> int:
        """Enqueue ``request``; returns its rid (submission order).
        Open-loop drivers pass ``arrival_time`` (``time.monotonic()``
        seconds), so admission also records wall-clock queue waits
        (``last_stats["classes"][cls]["wait_wall_ms_*"]``)."""
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
                          priority=priority, deadline=request.deadline,
                          arrival_time=arrival_time)
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
            # a deferred chunk was dispatched with the old snapshot, and
            # in-place slot writes are ordered behind it on the stream
            self.bank = eng.bank_for(sc)
            self._bank_epoch = eng.registry.bank_epoch
            self.bank_refreshes += 1
        flushed: List[Tuple[int, List[int], bool]] = []
        if self._pending is not None and (
                sched.queued or sched.prefill_pending
                or self._growth_possible()):
            # admission or planning may preempt a slot, whose replay
            # (prompt + emitted) must hold the deferred chunk's tokens
            flushed = self._flush_pending()
        rk = self.rk
        for slot, cid in sched.admit():
            self.ids[slot] = eng.registry.acquire(cid)
            if rk is None:
                self.cache = reset_slot(self.cache, slot)
            elif rk.lo <= slot < rk.hi:
                self.cache = reset_slot(self.cache, slot - rk.lo)
            self._ids_dev = None
        plan = sched.prepare_chunk(self.T, self.cap)
        if plan is None:
            if sched.has_work:
                raise RuntimeError("scheduler stalled with queued work")
            return flushed
        ver = self.kv.table_version
        mine = self._mine
        if not sc.overlap or ver != self._tables_ver:
            if rk is not None and rk.data > 1:
                self._bt_dev, self._lens_dev = self.kv.device_tables(
                    dev, rk.shards)
            else:
                self._bt_dev, self._lens_dev = self.kv.device_tables(dev)
            self._tables_ver, self._lens_ok = ver, True
            # a table move can change the active set or a slot's feed
            self._last_ok, self._act_dev = False, None
        elif not self._lens_ok:
            self._lens_dev = to_device(mine(self.kv.lengths), dev)
            self._lens_ok = True
        if self._ids_dev is None:
            self._ids_dev = to_device(mine(self.ids), dev)
        bt, lens, ids = self._bt_dev, self._lens_dev, self._ids_dev
        if plan[0] == "prefill":
            arrs = sched.prefill_arrays(self.T)
            sampled, self.cache, self._lens_dev = eng._prefill_chunk(
                self.bank, ids, self.cache,
                to_device(mine(arrs["tokens"]), dev), lens,
                to_device(mine(arrs["n_new"]), dev), bt, self.gen,
                sc.temperature, sc.paged_backend, rk)
            self._last_ok = False         # completing prompts seed the feed
            # a chunk that emits no token is never read back
            # (observe_prefill reads samples of emitting rows only)
            emits = not sc.overlap or sched.chunk_emits(arrs["n_new"])
            return flushed + sched.observe_prefill(
                arrs["n_new"], _Readback(sampled).numpy() if emits else None,
                eos_id=sc.eos_id)
        if plan[0] == "verify":
            arrs = sched.verify_arrays(self.Tv)
            greedy, self.cache = eng._verify_chunk(
                self.bank, ids, self.cache,
                to_device(mine(arrs["tokens"]), dev), lens,
                to_device(mine(arrs["n_new"]), dev), bt, sc.paged_backend,
                rk)
            # acceptance decides the advance and rollback on the host
            self._lens_ok, self._last_ok = False, False
            return flushed + sched.observe_verify(
                arrs["n_new"], _Readback(greedy).numpy(), eos_id=sc.eos_id)
        n = plan[1]
        defer = self._defer_cfg_ok and sched.chunk_defer_safe(n)
        if sc.overlap and self._last_ok:
            last, act = self._last_dev, self._act_dev
        else:
            st = sched.chunk_arrays()
            last, act = (to_device(mine(st["last"]), dev),
                         to_device(mine(st["active"]), dev))
        out, self.cache, self._lens_dev, self._last_dev = eng._decode_chunk(
            self.bank, ids, self.cache, last, act, lens, bt, n, self.gen,
            sc.temperature, sc.paged_backend, rk)
        self._act_dev, self._last_ok = act, sc.overlap
        got = _Readback(out)              # enqueued before the next chunk
        if self._pending is not None:
            # the chunk just dispatched runs while the host waits for the
            # deferred one
            flushed = self._flush_pending()
        if defer:
            self._pending = (got, n, sched.observe_chunk_counts(n))
            self.deferred_chunks += 1
            return flushed
        return flushed + sched.observe_chunk(got.numpy(), eos_id=sc.eos_id)

    def _mine(self, arr):
        """This rank's rows of a per-slot host array (all of them with no
        mesh)."""
        return arr if self.rk is None else self.rk.rows(arr)

    # -- deferred observation ------------------------------------------------
    def _growth_possible(self) -> bool:
        """Whether any active slot's next decode chunk (at most ``cap``
        steps) could outgrow its blocks: growth is the only way a pure
        decode round preempts, so while this is False the next plan keeps
        the slot set and a deferred chunk may stay unread through it."""
        kv = self.kv
        return any(int(kv.lengths[slot]) + self.cap
                   > kv.owned_blocks(slot) * kv.block_size
                   for slot in self.sched.active_slots)

    def _flush_pending(self) -> List[Tuple[int, List[int], bool]]:
        """Read the deferred decode chunk back (waiting for it alone) and
        fold its values into the scheduler: its events, one round late."""
        got, n, slots = self._pending
        self._pending = None
        return self.sched.observe_chunk_values(slots, got.numpy()[:n])

    # -- drain ---------------------------------------------------------------
    def finalize(self) -> dict:
        """Build ``engine.last_stats`` for this session (idempotent)."""
        if self._finalized:
            return self.engine.last_stats
        self._finalized = True
        if self._pending is not None:     # stream abandoned mid-pipeline
            self._flush_pending()
        sc, sched, kv = self.sc, self.sched, self.kv
        classes = {}
        for cname in PRIORITY_CLASSES:
            waits = sched.wait_ticks.get(cname, [])
            walls = sched.wait_wall.get(cname, [])
            if not waits and cname not in sched.preemptions_by_class:
                continue
            entry = {
                "admitted": len(waits),
                "wait_p50": float(np.percentile(waits, 50)) if waits else 0.0,
                "wait_p99": float(np.percentile(waits, 99)) if waits else 0.0,
                "preemptions": sched.preemptions_by_class.get(cname, 0)}
            if walls:          # only when driven with arrival times
                entry["wait_wall_ms_p50"] = float(
                    np.percentile(walls, 50) * 1e3)
                entry["wait_wall_ms_p99"] = float(
                    np.percentile(walls, 99) * 1e3)
            classes[cname] = entry
        stats = {"prefill_dispatches": sched.prefill_dispatches,
                 "decode_dispatches": sched.decode_dispatches,
                 "decode_steps": sched.steps,
                 "deferred_chunks": self.deferred_chunks,
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
                 "mesh": (None if sc.mesh is None
                          else mesh_shape(sc.mesh)),
                 "kv_dtype": sc.kv_dtype,
                 "overlap": sc.overlap,
                 "paged_backend": sc.paged_backend,
                 "open_loop": self.open_loop,
                 # queue waits by class: wait_p50/p99 in admission rounds;
                 # wait_wall_ms_* when driven with arrival times
                 "classes": classes,
                 "victim_sealed_fraction_mean": (
                     float(np.mean(sched.victim_sealed_fractions))
                     if sched.victim_sealed_fractions else 0.0)}
        if sc.num_shards > 1:
            stats["shard_placements"] = dict(sched.placed)
        self.engine.last_stats = stats
        if sc.prefix_cache:
            self.engine._warm = (self._geom_key, self.kv, self.cache)
        return stats

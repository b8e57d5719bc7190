"""Serving CLI of the port: multi-tenant continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tenants 8 --batch 8 --requests 8 --new-tokens 32 \
        --prefill-chunk 256 --block-size 16 --paged-backend cuda

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --smoke --device cpu --paged-backend torch --tenants 3 --batch 2

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --kv-dtype int8 --ranks 4,8 --bank-dtype int8 --prefix-cache \
        --spec-decode

Open-loop asyncio serving (requests arrive on a synthetic trace at
wall-clock times, tokens stream back per request, graceful drain; see
``serving/trace.py`` for the workload generator):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tenants 2 --batch 4 --serve --trace-requests 8 \
        --trace-rate 20 --time-scale 0.05

Sharded serving (the pool, the slots and the bank split into placement
domains, one dispatch per round), with online re-registration mid-stream:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tenants 4 --batch 4 --shards 2 --update-every 3

The fixed-batch path: a mixed-tenant batch of one equal-length prompt
(``--no-continuous``), or one adapter tree through the single-tenant
``Engine`` (``--tenants 0``, with ``--dual`` for two seeded pairs merged
by Eq. 7, or ``--adapters`` for a checkpoint):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tenants 3 --batch 4 --no-continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tenants 0 --dual --batch 2

Any arch of the port, by ``--arch`` (``repro_torch.configs.ALL_ARCHS``):
the dense, MoE, SSM, hybrid and VLM families (internvl2-26b serves
text-only requests, as in the reference); the encoder-decoder
(whisper-small) needs audio embeddings and is refused, as the reference
refuses it.  mamba2-2.7b and jamba-v0.1-52b keep recurrent state per
slot, so they refuse ``--prefix-cache`` and ``--spec-decode``, as the
reference does:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --smoke --device cpu --tenants 2 --batch 2

Per-request token increments as chunks complete (``--stream``), and SLA
classes cycled over the requests (``--priority-mix``; the default puts
every request in ``batch``):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tenants 2 --batch 2 --stream \
        --priority-mix interactive,batch

Weights and adapters are random from ``--seed`` (the repo holds no trained
weights); each tenant registers one Eq. 7-fused adapter with a non-zero B.
Flag names are the reference CLI's (``repro.launch.serve``), plus
``--bank-dtype``.  Defaults that differ from the reference's: ``--tenants``
is 4 (the reference's 0 runs the single-tenant engine) and continuous
batching is on unless ``--no-continuous`` (the reference runs the fixed
path unless ``--continuous``).  With ``--prefix-cache`` the requests run
twice, the second time against the warm pool.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import time
from collections import deque
from typing import (Any, AsyncIterator, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.dual_lora import merge
from repro_torch.core.lora import init_adapters
from repro_torch.core.partition import mesh_coordinate, mesh_shape
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.launch.mesh import data_group, model_group
from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.serving.engine import (Engine, MultiTenantEngine, Request,
                                        ServeConfig)
from repro_torch.serving.kv_cache import (PagedKVCache, blocks_needed,
                                          to_device)
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.scheduler import PRIORITY_CLASSES
from repro_torch.serving.sharded import ShardedAdapterRegistry
from repro_torch.serving.trace import synth_trace
from repro_torch.training.checkpoint import load_checkpoint


class AsyncServer:
    """Asyncio front end over an open-loop :class:`StreamSession`.

    Callers ``await submit(request)`` at any time, also while other
    requests are mid-flight, and consume their tokens via ``async for toks
    in stream(rid)``.  One pump coroutine owns the session: it drains
    staged submissions between engine rounds (so scheduler state is only
    touched from the event loop's thread) and runs each blocking
    :meth:`StreamSession.step` in the default executor, on the CUDA stream
    that was current when the server started (a thread's current stream is
    its own), so the event loop stays responsive while the card computes.

    ``await drain()`` shuts down gracefully: accepted requests run to
    completion, later ``submit`` calls are rejected, and the session's
    ``last_stats`` (wall-clock queue waits per class) come back.  ``async
    with AsyncServer(...)`` drains on exit.
    """

    def __init__(self, engine: MultiTenantEngine, sc: ServeConfig):
        self._engine = engine
        self._ses = engine.session(sc)          # open loop: starts empty
        self._staged: deque = deque()           # (Request, arrival, Future)
        self._queues: Dict[int, asyncio.Queue] = {}
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stream = None
        self._closing = False
        self.stats: Optional[dict] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AsyncServer":
        if self._pump_task is None:
            if self._engine.device.type == "cuda":
                self._stream = torch.cuda.current_stream(self._engine.device)
            self._wake = asyncio.Event()
            self._pump_task = asyncio.ensure_future(self._pump())
        return self

    async def drain(self) -> dict:
        """Stop accepting; run accepted requests to completion; return the
        session's ``last_stats``."""
        self._closing = True
        if self._pump_task is not None:
            self._wake.set()
            await self._pump_task
        else:
            self.stats = self._ses.finalize()
        return self.stats

    async def __aenter__(self) -> "AsyncServer":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.drain()

    # -- client API ----------------------------------------------------------
    async def submit(self, request: Request) -> int:
        """Stage ``request`` and return its rid once the pump accepts it.
        The submission's wall-clock time is the request's arrival, so the
        queue waits in ``last_stats`` are end to end."""
        if self._closing:
            raise RuntimeError("AsyncServer is draining; submit rejected")
        if self._pump_task is None:
            raise RuntimeError("AsyncServer not started (use 'async with' "
                               "or call start())")
        fut = asyncio.get_running_loop().create_future()
        self._staged.append((request, time.monotonic(), fut))
        self._wake.set()
        return await fut

    async def stream(self, rid: int) -> AsyncIterator[List[int]]:
        """Token increments of one request, ending after its final chunk
        (budget reached or EOS)."""
        q = self._queues[rid]
        while True:
            toks, fin = await q.get()
            if toks:
                yield toks
            if fin:
                return

    # -- engine pump ---------------------------------------------------------
    def _step(self):
        if self._stream is None:
            return self._ses.step()
        with torch.cuda.stream(self._stream):
            return self._ses.step()

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        ses = self._ses
        while True:
            while self._staged:                 # intake between rounds
                req, arrival, fut = self._staged.popleft()
                rid = ses.submit(req, arrival_time=arrival)
                self._queues[rid] = asyncio.Queue()
                fut.set_result(rid)
            if not ses.has_work:
                if self._closing:
                    break
                self._wake.clear()              # idle: park until a submit
                await self._wake.wait()
                continue
            events = await loop.run_in_executor(None, self._step)
            for rid, toks, fin in events:
                q = self._queues.get(rid)
                if q is not None:
                    q.put_nowait((list(toks), fin))
                    if fin:
                        self._queues.pop(rid, None)
        self.stats = ses.finalize()


def print_class_stats(stats: dict) -> None:
    """Per-class queue waits: wall-clock percentiles for a session driven
    with arrival times, admission rounds otherwise."""
    for cname, cs in stats["classes"].items():
        if "wait_wall_ms_p50" in cs:
            print(f"  class {cname}: {cs['admitted']} admitted, "
                  f"queue wait p50 {cs['wait_wall_ms_p50']:.1f} / "
                  f"p99 {cs['wait_wall_ms_p99']:.1f} ms wall, "
                  f"{cs['preemptions']} preemptions")
        else:
            print(f"  class {cname}: {cs['admitted']} admitted, "
                  f"queue wait p50 {cs['wait_p50']:.0f} / "
                  f"p99 {cs['wait_p99']:.0f} rounds, "
                  f"{cs['preemptions']} preemptions")


async def serve_demo(eng: MultiTenantEngine, sc: ServeConfig, trace,
                     time_scale: float) -> dict:
    """Drive an open-loop trace through :class:`AsyncServer`: one client
    coroutine per entry sleeps until its scheduled arrival, submits and
    consumes its stream; the server drains once every request finished."""
    t0 = time.monotonic()
    lat: Dict[int, Tuple[float, int]] = {}          # entry -> (ttft, tokens)
    async with AsyncServer(eng, sc) as srv:
        async def client(i, e):
            sched = e.arrival_s * time_scale
            await asyncio.sleep(max(0.0, sched - (time.monotonic() - t0)))
            rid = await srv.submit(e.request())
            first, n = None, 0
            async for toks in srv.stream(rid):
                if first is None:
                    first = time.monotonic() - t0
                n += len(toks)
            lat[i] = (first - sched, n)

        await asyncio.gather(*(client(i, e) for i, e in enumerate(trace)))
        elapsed = time.monotonic() - t0
    ttfts = [v[0] for v in lat.values()]
    total = sum(v[1] for v in lat.values())
    print(f"open-loop serve on {eng.device}: {len(trace)} requests, {total} "
          f"tokens in {elapsed:.2f}s ({total / elapsed:.1f} tok/s goodput); "
          f"TTFT p50 {1e3 * float(np.percentile(ttfts, 50)):.1f} / p99 "
          f"{1e3 * float(np.percentile(ttfts, 99)):.1f} ms "
          f"[overlap={'on' if sc.overlap else 'off'}, "
          f"{srv.stats['deferred_chunks']} deferred decode chunks]")
    print_class_stats(srv.stats)
    return srv.stats


def register_client(registry, cfg, i: int, device, seed: int, ranks=None):
    """Register ``client{i}``: two seeded pairs (non-zero B) fused by Eq. 7
    at (0.6, 0.6), at rank ``ranks[i % len(ranks)]`` with ``ranks``."""
    rk = ranks[i % len(ranks)] if ranks else None
    pair = [init_adapters(cfg, rk, seed=seed + j, device=device, b_std=0.02)
            for j in (0, 1)]
    return registry.register_dual(f"client{i}", *pair, [0.6, 0.6])


def build_engine(cfg, tenants: int, device, seed: int = 0, rank=None,
                 ranks=None, bank_dtype: str = "f32",
                 shards: int = 1, shard=None) -> MultiTenantEngine:
    """Random base weights plus ``tenants`` registered fused adapters.
    ``rank`` sets the model's ``lora_rank`` (and so the scale α/r the
    engine serves with); ``ranks`` makes a ragged bank with client i at
    ``ranks[i % len(ranks)]`` and twice the tenants' slots, as the
    reference CLI does; ``shards > 1`` a :class:`ShardedAdapterRegistry`,
    its capacity rounded up to whole shards of at least one slot per
    bucket.  ``shard`` (size, rank): the engine holds that rank's shard of
    a ``size``-way "model" axis, drawn as it is cut (``Model.init``), and
    serves over such a mesh only.  The encoder-decoder is refused, as the
    engine's paged pools refuse it (``Model.check_paged``), with a mesh
    or without."""
    if rank:
        cfg = cfg.with_overrides(lora_rank=rank)
    model = Model(cfg, device=device)
    model.check_paged()              # the engine's pools refuse encdec
    params = model.init(seed, shard=shard)
    cap = 2 * tenants if ranks else tenants
    cap = max(cap, shards * max(1, len(set(ranks or ()))))
    if shards > 1:
        cap = -(-cap // shards) * shards
        registry = ShardedAdapterRegistry(cfg, capacity=cap,
                                          num_shards=shards,
                                          ranks=ranks or None,
                                          bank_dtype=bank_dtype,
                                          device=device)
    else:
        registry = AdapterRegistry(cfg, capacity=cap, ranks=ranks or None,
                                   bank_dtype=bank_dtype, device=device)
    for i in range(tenants):
        register_client(registry, cfg, i, device, 10 + 2 * i, ranks)
    if shard is None:
        return MultiTenantEngine(model, cfg, params, registry)
    eng = MultiTenantEngine(model, cfg, None, registry)
    eng.hold_shard(*shard, params)
    return eng


def demo_prompt(vocab: int) -> np.ndarray:
    """The reference CLI's fixed-path prompt: a byte-tokenized log line."""
    ids = ByteTokenizer().encode("logs: job start | net link up anomaly? ")
    return np.asarray(ids[:32], np.int32) % vocab


def single_tenant(args, cfg) -> None:
    """``--tenants 0``: one adapter tree (``--adapters`` checkpoint,
    ``--dual`` two seeded pairs merged by Eq. 7, else none) through the
    single-tenant :class:`Engine` on a batch of the demo prompt."""
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    adapters = None
    if args.adapters:
        adapters = load_checkpoint(args.adapters, device=args.device)
    elif args.dual:
        pair = [init_adapters(cfg, seed=s, device=args.device, b_std=0.02)
                for s in (1, 2)]
        adapters = merge(*pair, [0.6, 0.6])
    eng = Engine(model, cfg, params, adapters)
    sc = ServeConfig(batch_size=args.batch, max_new_tokens=args.new_tokens,
                     cache_len=args.cache_len,
                     paged_backend=args.paged_backend)
    prompts = np.tile(demo_prompt(cfg.vocab_size), (args.batch, 1))
    t0 = time.perf_counter()
    out = eng.generate(prompts, sc)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    what = ("checkpoint" if args.adapters else
            "Eq. 7-merged pair" if args.dual else "no adapter")
    print(f"single tenant ({what}) on {eng.device}: {out.numel()} tokens "
          f"in {dt:.3f}s over {args.batch} rows, cache_len "
          f"{sc.cache_len}")
    print(f"  sample: {out[0, :12].tolist()}")


def fixed_demo(eng, args, sc) -> None:
    """``--no-continuous``: one mixed-tenant batch of the demo prompt
    through ``generate_fixed`` (row b to ``client{b % tenants}``)."""
    prompt = demo_prompt(eng.cfg.vocab_size)
    reqs = [Request(f"client{b % args.tenants}", prompt)
            for b in range(args.batch)]
    t0 = time.perf_counter()
    out = eng.generate_fixed(reqs, sc)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    print(f"{args.tenants} tenants resident, fixed mixed batch of "
          f"{args.batch} on {eng.device}: {out.numel()} tokens in "
          f"{dt:.3f}s")
    for b in range(min(args.batch, args.tenants)):
        print(f"  {reqs[b].client_id}: {out[b, :12].tolist()}")


def ragged_requests(n: int, tenants: int, vocab: int, prompt_min: int,
                    prompt_max: int, seed: int = 0, mix=()):
    """``n`` requests of seeded random prompts, request i to
    ``client{i % tenants}`` in class ``mix[i % len(mix)]`` (``"batch"``
    with no mix)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_min, prompt_max + 1, n)
    return [Request(f"client{i % tenants}",
                    rng.integers(0, vocab, int(s)).astype(np.int32),
                    priority=mix[i % len(mix)] if mix else "batch")
            for i, s in enumerate(lens)]


# ---------------------------------------------------------------------------
# one engine served on every rank of a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeJob:
    """An engine (``build_engine``: random weights and ``tenants`` fused
    adapters from ``seed``) and the runs it serves: each ``(name, mesh,
    ServeConfig keywords)``, ``mesh`` a ("pod", "data", "model") shape or
    None (no mesh).  ``first_chunk`` names the runs whose first prefill
    chunk's logits (this rank's rows and vocabulary block) are kept, with
    each MoE layer's routing ids and dropped copies there.  The whole base
    is freed once every later run is at "model" > 1, so those ranks hold
    their shard only; where every run is on one mesh of "model" > 1, the
    base is drawn shard by shard and never held whole."""
    cfg: Any                          # the port's ModelConfig
    requests: Sequence[Request]
    runs: Sequence[Tuple[str, Optional[Tuple[int, int, int]], Dict]]
    tenants: int = 8
    seed: int = 0
    device: str = "cuda"
    first_chunk: Sequence[str] = ()


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed_stream(eng, reqs, sc):
    """``generate_stream`` with host times: (streams, TTFT per request in
    s, seconds of the decode phase, tokens emitted in it, total seconds).
    The decode phase starts at the last request's first token."""
    outs: List[List[int]] = [[] for _ in reqs]
    first: List[Any] = [None] * len(reqs)
    stamps = []
    _sync(eng.device)
    t0 = time.perf_counter()
    for rid, toks, _ in eng.generate_stream(reqs, sc):
        now = time.perf_counter() - t0        # events follow a readback
        if first[rid] is None:
            first[rid] = now
        outs[rid].extend(toks)
        stamps.append((now, len(toks)))
    total = time.perf_counter() - t0
    t_dec0 = max(first)
    return (outs, first, total - t_dec0,
            sum(n for t, n in stamps if t > t_dec0), total)


def first_chunk_logits(eng, reqs, sc, rows=None):
    """Logits of the first prefill dispatch a stream of ``reqs`` makes
    (every request on a slot, a fresh pool), as this rank of ``sc.mesh``
    computes them: its rows (a block of the slots over "data", an MoE
    layer's dispatch over every rank's) on its shards of base, bank, kv
    heads and experts, its vocabulary block.  ``rows`` (lo, hi): those
    rows alone, on one device, as a data rank of a model without MoE
    layers computes them.  Returns (logits (rows, T, V / model), n_new
    (rows,))."""
    B = len(reqs)
    span = max(len(r.prompt) + (sc.max_new_tokens if r.max_new_tokens is None
                                else r.max_new_tokens) for r in reqs)
    T = max(1, min(sc.prefill_chunk, span - 1))
    per = blocks_needed(span, sc.block_size)
    tp = dp = None
    if sc.mesh is not None:
        data = mesh_shape(sc.mesh).get("data", 1)
        d = mesh_coordinate(sc.mesh).get("data", 0)
        rows = (d * B // data, (d + 1) * B // data)
        tp = model_group(sc.mesh)
        dp = data_group(sc.mesh)
    if rows is not None:
        reqs = reqs[rows[0]:rows[1]]
    b = len(reqs)
    kv = PagedKVCache(b, sc.block_size, 1 + b * per, per)
    tokens = np.zeros((b, T), np.int32)
    n_new = np.zeros((b,), np.int32)
    for i, r in enumerate(reqs):
        kv.admit(i)
        n_new[i] = min(T, len(r.prompt))
        kv.ensure(i, int(n_new[i]))
        tokens[i, :n_new[i]] = np.asarray(r.prompt[:n_new[i]])
    dev = eng.device
    bt, lens = kv.device_tables(dev)
    ids = to_device(np.asarray([eng.registry.acquire(r.client_id)
                                for r in reqs], np.int32), dev)
    cache = eng.model.init_paged_decode_cache(
        1 + b * per, sc.block_size, kv_dtype=sc.kv_dtype, num_slots=b, tp=tp)
    logits, _ = eng.model.prefill_step(
        eng.params_for(sc), cache, to_device(tokens, dev), lens,
        to_device(n_new, dev), adapters=eng.bank_for(sc),
        lora_scale=eng.scale, adapter_ids=ids, block_tables=bt,
        paged_backend=sc.paged_backend, tp=tp, dp=dp)
    return logits, torch.from_numpy(n_new)


def serve_runs(eng, job: ServeJob, meshes=None) -> Dict[str, Dict]:
    """``job``'s runs on ``eng`` in this process, each after a short
    warm-up on its mesh's first use (cuBLAS handles, the allocator, the
    kernels' first launches, the collectives' groups): per run its
    streams, TTFT, decode seconds and tokens, stats, collectives, kernel
    launches and tiles, peak memory and, where asked, its first chunk's
    logits (:func:`first_chunk_logits`) with its routing (each MoE
    layer's router logits, ids and dropped copies, ``moe.RoutingLog``).
    ``meshes``: meshes already made, by shape."""
    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_lib
    dev = eng.device
    meshes = dict(meshes or {})
    out = {}
    for i, (name, shape, kw) in enumerate(job.runs):
        mesh = None
        if shape is not None:
            fresh = shape not in meshes
            if fresh:
                meshes[shape] = mesh_lib.make_mesh(*shape, device=dev)
            mesh = meshes[shape]
        else:
            fresh = "none" not in meshes
            meshes["none"] = None
        sc = ServeConfig(mesh=mesh, **kw)
        if eng.params is not None and all(
                s is not None and s[2] > 1 for _, s, _ in job.runs[i:]):
            eng.params_for(sc)             # the shard, then the base goes
            eng.params = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if fresh:
            warm = ragged_requests(sc.num_shards * 2, job.tenants,
                                   job.cfg.vocab_size, 8, 16, job.seed + 1)
            eng.generate(warm, dataclasses.replace(
                sc, batch_size=len(warm), max_new_tokens=2, prefill_chunk=8,
                prefix_cache=False, spec_decode=False, num_blocks=None))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        mesh_lib.reset_collectives()
        streams, ttft, dec_s, dec_tok, total = timed_stream(
            eng, job.requests, sc)
        res = {"mesh": shape, "streams": streams, "ttft_s": ttft,
               "decode_s": dec_s, "decode_tokens": dec_tok,
               "total_s": total, "stats": eng.last_stats,
               "collectives": [dataclasses.asdict(c)
                               for c in mesh_lib.collectives()],
               "launches": kernels.launch_counts(),
               "tiles": kernels.tile_counts(),
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
               "coord": {} if mesh is None else mesh_coordinate(mesh)}
        if name in job.first_chunk:
            with torch.no_grad(), moe.RoutingLog() as rec:
                res["first_chunk"] = first_chunk_logits(eng, job.requests,
                                                        sc)
            res["first_chunk_routing"] = {"logits": rec.logits,
                                          "ids": rec.ids,
                                          "dropped": rec.dropped}
        out[name] = res
    return out


def mesh_serve(job: ServeJob) -> Dict[str, Dict]:
    """The rank program of :class:`ServeJob` (``launch/mesh.spawn``
    runs it on every rank; at world size 1 in the caller's process):
    build the engine from ``job.seed`` (where every run is on one mesh of
    "model" > 1, this rank's shard of the base only) and
    :func:`serve_runs`."""
    from repro_torch.launch import mesh as mesh_lib
    shapes = {s for _, s, _ in job.runs}
    shard, meshes = None, {}
    if len(shapes) == 1 and None not in shapes and max(shapes)[2] > 1:
        shape = max(shapes)
        meshes[shape] = mesh_lib.make_mesh(*shape, device=job.device)
        shard = (shape[2], mesh_coordinate(meshes[shape])["model"])
    eng = build_engine(job.cfg, job.tenants, job.device, job.seed,
                       shard=shard)
    out = serve_runs(eng, job, meshes)
    del eng
    gc.collect()
    if torch.device(job.device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def stream_with_updates(eng, reqs, sc, args, ranks):
    """Collect ``generate_stream``; with ``--stream`` print each increment
    on the reference CLI's line; with ``--update-every N`` every N-th
    event re-registers the next client (round-robin) with fresh seeded
    pairs, as a finished federated round would publish it.  Returns
    (per-request streams, re-registrations)."""
    outs = [[] for _ in reqs]
    updates = events = 0
    tok = ByteTokenizer()
    for rid, toks, finished in eng.generate_stream(reqs, sc):
        outs[rid].extend(toks)
        if args.stream:
            tag = " <done>" if finished else ""
            print(f"  [stream] req{rid} +{len(toks)} ({len(outs[rid])} "
                  f"total){tag}: {tok.decode(np.asarray(toks))[:24]!r}")
        events += 1
        if args.update_every and events % args.update_every == 0:
            register_client(eng.registry, eng.cfg, updates % args.tenants,
                            eng.device, 1000 + 2 * updates, ranks or None)
            updates += 1
    return [np.asarray(o, np.int32) for o in outs], updates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=4,
                    help="N resident client adapters; 0 serves one adapter "
                         "tree through the single-tenant Engine")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--continuous", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="with --tenants: continuous batching (the port's "
                         "default); --no-continuous runs one fixed mixed "
                         "batch through generate_fixed")
    ap.add_argument("--cache-len", type=int, default=256,
                    help="fixed path: decode cache length")
    ap.add_argument("--adapters", default="",
                    help="--tenants 0: npz checkpoint to serve")
    ap.add_argument("--dual", action="store_true",
                    help="--tenants 0: serve two seeded pairs merged by "
                         "Eq. 7 at (0.6, 0.6)")
    ap.add_argument("--shards", type=int, default=1,
                    help="split the paged pool, the slots and the adapter "
                         "bank into N shards with placement-aware "
                         "admission (streams equal --shards 1)")
    ap.add_argument("--update-every", type=int, default=0,
                    help="continuous mode: every N stream events re-register "
                         "one client's fused adapter mid-serve "
                         "(round-robin); the session hot-swaps the bank at "
                         "its next round")
    ap.add_argument("--requests", type=int, default=0,
                    help="queued requests (default 2x batch)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--paged-backend", default=None, choices=["cuda", "torch"],
                    help="default: 'cuda' on a card, 'torch' on the CPU")
    ap.add_argument("--sched-policy", default="sla", choices=["sla", "fcfs"])
    ap.add_argument("--stream", action="store_true",
                    help="continuous mode: print each request's token "
                         "increments as chunks complete (generate_stream)")
    ap.add_argument("--priority-mix", default="",
                    help="continuous mode: comma list of classes "
                         "(interactive,batch,background) cycled over the "
                         "requests, e.g. 'batch,batch,interactive'; empty: "
                         "all batch")
    ap.add_argument("--kv-dtype", default="f32", choices=["f32", "int8"],
                    help="paged K/V storage: 'int8' quantizes blocks with "
                         "per-(block, position, kv-head) scales")
    ap.add_argument("--bank-dtype", default="f32", choices=["f32", "int8"],
                    help="adapter bank storage: 'int8' quantizes each "
                         "client's factors per layer")
    ap.add_argument("--ranks", default="",
                    help="comma list of rank buckets (e.g. '4,8'): client "
                         "i registers at ranks[i %% len], padded into its "
                         "bucket")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed shared K/V blocks within and "
                         "across calls (runs the requests twice to show "
                         "the warm hit rate)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="greedy speculative decoding with prompt-lookup "
                         "drafts (tokens equal to plain decoding)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --spec-decode: max drafted tokens per slot "
                         "per verify round")
    ap.add_argument("--serve", action="store_true",
                    help="open-loop asyncio serving: requests arrive on a "
                         "synthetic trace at wall-clock times, tokens "
                         "stream back per request, graceful drain; reports "
                         "TTFT percentiles and wall-clock queue waits")
    ap.add_argument("--trace-requests", type=int, default=24,
                    help="--serve: trace length (requests)")
    ap.add_argument("--trace-arrival", default="bursty",
                    choices=["poisson", "bursty"],
                    help="--serve: arrival process (same long-run rate)")
    ap.add_argument("--trace-rate", type=float, default=20.0,
                    help="--serve: mean arrival rate, requests/second")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="--serve: workload generator seed")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="--serve: multiply trace arrival times (<1 "
                         "compresses the trace: higher load)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the synchronous loop instead of overlapped "
                         "dispatch (tokens are equal either way)")
    args = ap.parse_args(argv)
    mix = [c.strip() for c in args.priority_mix.split(",") if c.strip()]
    unknown = sorted(set(mix) - set(PRIORITY_CLASSES))
    if unknown:
        ap.error(f"--priority-mix: unknown classes {unknown} (have "
                 f"{sorted(PRIORITY_CLASSES, key=PRIORITY_CLASSES.get)})")

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encdec:
        raise SystemExit("enc-dec serving needs audio embeds; use tests/"
                         "test_models.py::test_whisper_prefill_cross for the "
                         "path")
    if args.tenants <= 0:
        if args.continuous or args.serve:
            raise SystemExit("--continuous/--serve need --tenants N (the "
                             "continuous scheduler serves the multi-tenant "
                             "engine)")
        return single_tenant(args, cfg)
    if args.adapters or args.dual:
        raise SystemExit("--tenants is a self-contained demo (random fused "
                         "adapters per tenant); it cannot combine with "
                         "--adapters/--dual")
    if args.update_every and args.prefix_cache:
        raise SystemExit("--update-every re-registers adapters mid-serve, "
                         "so the --prefix-cache warm-call check cannot "
                         "hold; pick one")
    ranks = [int(r) for r in args.ranks.split(",") if r.strip()]
    eng = build_engine(cfg, args.tenants, args.device, args.seed,
                       ranks=ranks or None,
                       bank_dtype=args.bank_dtype, shards=args.shards)
    if ranks:
        print(f"ragged adapter bank: buckets {eng.registry.bucket_ranks}, "
              f"per-slot ranks {eng.registry.slot_ranks().tolist()}")
    sc = ServeConfig(batch_size=args.batch, max_new_tokens=args.new_tokens,
                     prefill_chunk=args.prefill_chunk,
                     block_size=args.block_size,
                     sched_policy=args.sched_policy,
                     paged_backend=args.paged_backend,
                     kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
                     spec_decode=args.spec_decode, spec_k=args.spec_k,
                     overlap=not args.no_overlap, num_shards=args.shards,
                     cache_len=args.cache_len)
    if args.continuous is False:
        return fixed_demo(eng, args, sc)
    if args.serve:
        # an open-loop session needs its pool pinned: batch_size slots of
        # the worst-case span (prompt_max + out_max), whole shards
        bp = blocks_needed(args.prompt_max + args.new_tokens, sc.block_size)
        nb = -(-args.batch * bp // args.shards) * args.shards
        sc.num_blocks, sc.max_blocks_per_slot = 1 + nb, bp
        trace = synth_trace(
            args.trace_seed, args.trace_requests, arrival=args.trace_arrival,
            rate=args.trace_rate, prompt_max=args.prompt_max,
            out_max=args.new_tokens,
            clients=tuple(f"client{i}" for i in range(args.tenants)),
            vocab_size=cfg.vocab_size)
        asyncio.run(serve_demo(eng, sc, trace, args.time_scale))
        return
    reqs = ragged_requests(args.requests or 2 * args.batch, args.tenants,
                           cfg.vocab_size, args.prompt_min, args.prompt_max,
                           args.seed, mix)
    backend = args.paged_backend or ("cuda" if eng.device.type == "cuda"
                                     else "torch")
    for run in ("cold", "warm") if args.prefix_cache else ("cold",):
        t0 = time.perf_counter()
        outs, updates = stream_with_updates(eng, reqs, sc, args, ranks)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - t0
        st = eng.last_stats
        total = sum(o.size for o in outs)
        print(f"{args.tenants} tenants, {len(reqs)} ragged requests over "
              f"{args.batch} slots on {eng.device}: {total} tokens in "
              f"{dt:.3f}s ({st['prefill_dispatches']} prefill + "
              f"{st['decode_dispatches']} decode + "
              f"{st['verify_dispatches']} verify dispatches, "
              f"{st['preemptions']} preemptions, backend={backend}, "
              f"kv={sc.kv_dtype}, bank={args.bank_dtype})")
        if args.prefix_cache:
            print(f"  prefix cache ({run}): {st['prefix_hit_tokens']} of "
                  f"{st['prompt_tokens']} prompt tokens hit, pool reused "
                  f"{st['prefix_pool_reused']}")
        if args.shards > 1:
            print(f"  {args.shards} shards: placements "
                  f"{st['shard_placements']} (prefix > adapter home > "
                  f"least loaded)")
        if args.update_every:
            print(f"  online updates: {updates} mid-serve re-registrations, "
                  f"{st['adapter_bank_refreshes']} bank hot-swaps")
        if args.spec_decode:
            print(f"  spec decode (k={sc.spec_k}): "
                  f"{st['accepted_tokens']}/{st['drafted_tokens']} drafts "
                  f"accepted, {st['rollback_tokens']} rolled back")
    for r, o in list(zip(reqs, outs))[:args.tenants]:
        print(f"  {r.client_id} (S={len(r.prompt)}): {o[:12].tolist()}")


if __name__ == "__main__":
    main()

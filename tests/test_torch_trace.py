"""Overlapped dispatch, the open-loop trace driver and the asyncio front
end of the port (CPU), against the reference package.

* ``synth_trace`` gives the reference's trace, bit for bit.
* Logical mode (arrivals mapped to engine rounds) runs the same dispatches
  with ``ServeConfig.overlap`` on and off: the port's streams must be
  bitwise equal both ways (ragged, preemption, warm prefix cache, spec
  decode, sampled), and with overlap on equal the JAX engine's greedy
  streams and scheduler counters (the JAX runs are module-scoped).
* Realtime replays, wall-clock queue waits, device snapshots, a bank
  hot-swap between pipelined rounds, ``AsyncServer`` and ``--serve``.

The configurations are the reference's own (``tests/test_trace_serving.py``).
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.serving.trace import run_trace as j_run_trace
from repro.serving.trace import synth_trace as j_synth_trace
from repro_torch import bridge
from repro_torch.launch.serve import AsyncServer
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.kv_cache import PagedKVCache, to_device
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.trace import run_trace, synth_trace

COUNTERS = ("prefill_dispatches", "decode_dispatches", "preemptions",
            "prompt_tokens", "prefix_hit_tokens", "verify_dispatches",
            "drafted_tokens", "accepted_tokens", "rollback_tokens")


def _tree(jcfg, seed):
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


@pytest.fixture(scope="module")
def base():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    pcfg = bridge.config_from_jax(jcfg)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, pcfg, jm, jp, pp


def _port_engine(base, clients=2):
    jcfg, pcfg, _, _, pp = base
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for i in range(clients):
        reg.register(f"c{i}", bridge.adapters_from_jax(_tree(jcfg, 100 + i),
                                                       device="cpu"))
    return MultiTenantEngine(Model(pcfg, device="cpu"), pcfg, pp, reg)


@pytest.fixture(scope="module")
def engines(base):
    jcfg, _, jm, jp, _ = base
    jreg = JRegistry(jcfg, capacity=4)
    for i in range(2):
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, _tree(jcfg, 100 + i)))
    return JEngine(jm, jcfg, jp, jreg), _port_engine(base)


def _sc(**kw):
    """The reference's open-loop pool for the tiny engine: 4 slots sized
    for the trace's worst-case span."""
    base = dict(batch_size=4, max_new_tokens=12, block_size=8,
                num_blocks=21, max_blocks_per_slot=5, prefill_chunk=4,
                scan_chunk=4)
    base.update(kw)
    return base


def _trace(seed=0, n=10, **kw):
    args = dict(arrival="bursty", rate=40.0, prompt_mean=8.0,
                prompt_max=24, out_mean=6.0, out_max=10)
    args.update(kw)
    return synth_trace(seed, n, **args)


def _prefix_trace():
    # one shared prompt of two full blocks, one client: later admissions
    # re-match the blocks the first request sealed
    shared = ((np.arange(16, dtype=np.int32) * 5) % 290 + 1).astype(np.int32)
    return [dataclasses.replace(e, prompt=shared.copy(), client_id="c0")
            for e in _trace(n=8)]


def _spec_trace():
    # repetitive prompts, so the prompt-lookup drafter fires
    return [dataclasses.replace(e, prompt=np.tile(e.prompt[:4], 6)[
        : e.prompt.size + 8].astype(np.int32)) for e in _trace(n=8)]


CASES = {
    "ragged": (_sc(), _trace),
    "preemption": (_sc(batch_size=3, num_blocks=8, max_blocks_per_slot=5),
                   lambda: _trace(n=12, rate=80.0, prompt_mean=16.0,
                                  out_mean=8.0)),
    "prefix_cache": (_sc(prefix_cache=True), _prefix_trace),
    "spec_decode": (_sc(spec_decode=True, spec_k=4), _spec_trace),
    "sampled": (_sc(temperature=0.7, seed=3), lambda: _trace(n=8)),
}


def _run(eng, sc_cls, runner, name, overlap, cold=True):
    kw, make = CASES[name]
    if cold:
        eng.release_prefix_cache()
    return runner(eng, sc_cls(**kw, overlap=overlap), make(),
                  rounds_per_s=6.0)


@pytest.fixture(scope="module")
def runs(engines):
    """Logical-mode reports, each run once per module: ("jax" | "port",
    case, overlap) -> report.  Prefix-cache runs start cold."""
    jeng, peng = engines
    memo = {}

    def get(kind, name, overlap=True):
        key = (kind, name, overlap)
        if key not in memo:
            memo[key] = (_run(jeng, JServeConfig, j_run_trace, name, overlap)
                         if kind == "jax" else
                         _run(peng, ServeConfig, run_trace, name, overlap))
        return memo[key]
    return get


def _assert_streams_equal(a, b):
    assert set(a["streams"]) == set(b["streams"])
    for rid in a["streams"]:
        assert a["streams"][rid] == b["streams"][rid], f"rid {rid}"


# ---------------------------------------------------------------------------
# the workload generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synth_trace_equals_the_reference(seed, arrival):
    kw = dict(arrival=arrival, rate=5.0, prompt_mean=40.0, prompt_max=300,
              out_mean=9.0, out_max=40, clients=("a", "b", "c"),
              client_weights=(1, 2, 3), vocab_size=500)
    got, want = synth_trace(seed, 60, **kw), j_synth_trace(seed, 60, **kw)
    assert len(got) == len(want) == 60
    for g, w in zip(got, want):
        assert (g.arrival_s, g.client_id, g.max_new_tokens, g.priority) == (
            w.arrival_s, w.client_id, w.max_new_tokens, w.priority)
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_run_trace_rejects_an_unsorted_trace(engines):
    e = synth_trace(0, 2)[0]
    bad = [dataclasses.replace(e, arrival_s=2.0),
           dataclasses.replace(e, arrival_s=1.0)]
    with pytest.raises(ValueError, match="sorted"):
        run_trace(engines[1], ServeConfig(**_sc()), bad)


# ---------------------------------------------------------------------------
# overlap on against off (the port), and against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ragged", "preemption", "prefix_cache",
                                  "spec_decode", "sampled"])
def test_overlap_streams_equal_the_synchronous_loop(engines, runs, name):
    on = runs("port", name, True)
    if name == "prefix_cache":
        # the synchronous run reuses the pool the overlapped run left warm
        off = _run(engines[1], ServeConfig, run_trace, name, False,
                   cold=False)
        assert off["last_stats"]["prefix_pool_reused"]
        engines[1].release_prefix_cache()
    else:
        off = runs("port", name, False)
    n = len(CASES[name][1]())
    assert on["completed"] == off["completed"] == n
    _assert_streams_equal(on, off)
    assert on["last_stats"]["overlap"] is True
    assert off["last_stats"]["overlap"] is False
    assert off["last_stats"]["deferred_chunks"] == 0
    st = on["last_stats"]
    assert {"preemption": st["preemptions"],
            "prefix_cache": st["prefix_hit_tokens"],
            "spec_decode": st["verify_dispatches"]}.get(name, 1) > 0


@pytest.mark.parametrize("name", ["ragged", "preemption", "prefix_cache",
                                  "spec_decode"])
def test_overlap_streams_equal_the_jax_engine(runs, name):
    got, want = runs("port", name), runs("jax", name)
    assert want["last_stats"]["overlap"] is True
    assert got["completed"] == want["completed"] == len(CASES[name][1]())
    _assert_streams_equal(got, want)
    for k in COUNTERS:
        assert got["last_stats"][k] == want["last_stats"][k], k
    # the same rounds: events surface when the reference's do (a deferred
    # chunk's one round late)
    assert got["elapsed"] == want["elapsed"]
    assert got["per_class"] == want["per_class"]


def test_decode_chunks_are_deferred_on_the_ragged_trace(engines):
    """The ragged pool with the trace's outputs up to 16 tokens, so decode
    chunks run cap-limited (no slot finishes inside one): some are read
    back one round late, and the streams still equal the synchronous
    loop's."""
    tr = _trace(out_mean=12.0, out_max=16)
    on, off = (run_trace(engines[1], ServeConfig(**_sc(), overlap=o), tr,
                         rounds_per_s=6.0) for o in (True, False))
    st = on["last_stats"]
    assert 0 < st["deferred_chunks"] <= st["decode_dispatches"]
    assert off["last_stats"]["deferred_chunks"] == 0
    assert on["completed"] == len(tr)
    _assert_streams_equal(on, off)


def test_realtime_streams_equal_logical_streams(engines, runs):
    """Greedy streams do not depend on when requests are submitted; the
    wall-clock queue waits exist only in the realtime (open-loop) run."""
    peng = engines[1]
    lo = runs("port", "ragged")
    rt = run_trace(peng, ServeConfig(**_sc()), _trace(), realtime=True,
                   time_scale=0.02)
    assert rt["mode"] == "realtime" and rt["unit"] == "ms"
    _assert_streams_equal(lo, rt)
    assert rt["completed"] == len(_trace())
    assert any("wait_wall_ms_p50" in cs
               for cs in rt["last_stats"]["classes"].values())
    assert not any("wait_wall_ms_p50" in cs
                   for cs in lo["last_stats"]["classes"].values())
    for d in rt["per_class"].values():
        assert d["ttft"]["p99"] >= d["ttft"]["p50"] >= 0.0


# ---------------------------------------------------------------------------
# what overlap must not break
# ---------------------------------------------------------------------------

def test_device_tensors_are_snapshots_not_views():
    """The host mutates its tables and ids in place while a dispatched
    chunk may still read the tensors it was given: each must be a copy
    (probed over many fresh pools: aliasing would depend on the
    allocator)."""
    for _ in range(20):
        kv = PagedKVCache(num_slots=4, block_size=4, num_blocks=8,
                          max_blocks_per_slot=2)
        kv.admit(0, scope="c0")
        kv.ensure(0, 4)
        bt, lens = kv.device_tables("cpu")
        ids = np.arange(4, dtype=np.int32)
        ids_dev = to_device(ids, "cpu")
        before = [t.clone() for t in (bt, lens, ids_dev)]
        kv.block_tables[:] = 77
        kv.lengths[:] = 55
        ids[:] = 9
        for t, b in zip((bt, lens, ids_dev), before):
            assert torch.equal(t, b)
        assert bt.dtype == lens.dtype == ids_dev.dtype == torch.int32


def test_registration_between_pipelined_rounds_keeps_other_streams(base):
    """c1 is registered again while c0's decode chunk is deferred (its
    readback one round late): c0's stream equals a run without the
    registration, and the session picks up the new bank."""
    jcfg = base[0]
    prompt = (np.arange(6, dtype=np.int32) * 7) % 290 + 1

    def serve(swap):
        eng = _port_engine(base)
        ses = eng.session(ServeConfig(**_sc()))
        r0 = ses.submit(Request("c0", prompt, max_new_tokens=12))
        r1 = ses.submit(Request("c1", prompt[:4], max_new_tokens=12))
        got, swapped = {r0: [], r1: []}, False
        while ses.has_work:
            for rid, toks, _ in ses.step():
                got[rid].extend(toks)
            if swap and not swapped and ses._pending is not None:
                eng.registry.register("c1", bridge.adapters_from_jax(
                    _tree(jcfg, 999), device="cpu"))
                swapped = True
        st = ses.finalize()
        return got[r0], st, swapped

    c0_swap, st, swapped = serve(True)
    c0_plain, st_plain, _ = serve(False)
    assert swapped and st["adapter_bank_refreshes"] == 1
    assert st["deferred_chunks"] > 0
    assert len(c0_swap) == 12 and c0_swap == c0_plain
    assert st_plain["adapter_bank_refreshes"] == 0


def test_closed_loop_stats_have_no_wall_waits(engines):
    peng = engines[1]
    prompt = (np.arange(8, dtype=np.int32) % 290) + 1
    peng.generate([Request(f"c{i % 2}", prompt, max_new_tokens=4)
                   for i in range(4)], ServeConfig(**_sc()))
    st = peng.last_stats
    assert st["open_loop"] is False and st["classes"]
    for cs in st["classes"].values():
        assert "wait_wall_ms_p50" not in cs and "wait_p50" in cs


# ---------------------------------------------------------------------------
# the asyncio front end and the CLI
# ---------------------------------------------------------------------------

def test_async_server_serves_and_drains(engines):
    peng = engines[1]
    prompt = (np.arange(9, dtype=np.int32) % 290) + 1

    async def run():
        out = {}
        async with AsyncServer(peng, ServeConfig(**_sc())) as srv:
            async def client(i):
                await asyncio.sleep(0.002 * i)
                rid = await srv.submit(Request(f"c{i % 2}", prompt[: 3 + i],
                                               max_new_tokens=3 + i))
                toks = []
                async for t in srv.stream(rid):
                    toks.extend(t)
                out[rid] = toks
            await asyncio.gather(*(client(i) for i in range(3)))
        return out, srv.stats

    out, stats = asyncio.run(run())
    assert sorted(out) == [0, 1, 2]
    for rid, toks in out.items():
        assert len(toks) == 3 + rid
    assert stats["open_loop"] is True
    assert any("wait_wall_ms_p50" in cs for cs in stats["classes"].values())


def test_async_server_rejects_after_drain(engines):
    peng = engines[1]
    prompt = (np.arange(6, dtype=np.int32) % 290) + 1

    async def run():
        srv = AsyncServer(peng, ServeConfig(**_sc())).start()
        rid = await srv.submit(Request("c0", prompt, max_new_tokens=2))
        toks = []
        async for t in srv.stream(rid):
            toks.extend(t)
        await srv.drain()
        with pytest.raises(RuntimeError, match="draining"):
            await srv.submit(Request("c0", prompt))
        return toks

    assert len(asyncio.run(run())) == 2


@pytest.mark.parametrize("overlap", [[], ["--no-overlap"]])
def test_serve_cli_open_loop_runs_on_cpu(capsys, overlap):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "2", "--batch", "2",
          "--serve", "--trace-requests", "4", "--trace-rate", "50",
          "--time-scale", "0.05", "--new-tokens", "4"] + overlap)
    out = capsys.readouterr().out
    assert "open-loop serve on cpu: 4 requests" in out
    assert f"overlap={'off' if overlap else 'on'}" in out
    assert "ms wall" in out

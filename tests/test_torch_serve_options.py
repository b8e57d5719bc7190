"""The port's serving options against the reference engine (CPU).

int8 K/V pools, ragged and int8 adapter banks, prefix caching within and
across calls, and greedy speculative decoding: on the same weights,
adapters and requests, greedy token streams and the scheduler's counters
(dispatches, preemptions, prefix hits, verify rounds, accepted and rolled
back drafts) must EQUAL the reference engine's with the same options.
int8 streams are held against the reference's int8 streams, never against
f32.  Inside the port, warm == cold and speculative == sequential hold
bitwise.
"""
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
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro_torch import bridge
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry

COUNTERS = ("prefill_dispatches", "decode_dispatches", "preemptions",
            "prompt_tokens", "prefix_hit_tokens", "prefix_pool_reused",
            "verify_dispatches", "drafted_tokens", "accepted_tokens",
            "rollback_tokens", "kv_dtype")


@pytest.fixture(scope="module")
def base():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    pcfg = bridge.config_from_jax(jcfg)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, pcfg, jm, jp, pp


def _tree(jcfg, seed, rank=None):
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def _engines(base, ranks_of_clients, **reg_kw):
    """A reference and a port engine over registries built with
    ``reg_kw``; client i registers an adapter at ``ranks_of_clients[i]``
    (None: the registry's rank)."""
    jcfg, pcfg, jm, jp, pp = base
    jreg = JRegistry(jcfg, **reg_kw)
    reg = AdapterRegistry(pcfg, device="cpu", **reg_kw)
    for i, rank in enumerate(ranks_of_clients):
        tree = _tree(jcfg, 100 + i, rank or reg_kw.get("rank"))
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    return (JEngine(jm, jcfg, jp, jreg),
            MultiTenantEngine(Model(pcfg, device="cpu"), pcfg, pp, reg))


def _run(engines, reqs, **kw):
    """Both engines on the same requests; returns (jax outputs, port
    outputs, jax stats, port stats)."""
    jeng, peng = engines
    jout = jeng.generate([JRequest(c, p, max_new_tokens=b)
                          for c, p, b in reqs],
                         JServeConfig(overlap=False, **kw))
    pout = peng.generate([Request(c, p, max_new_tokens=b)
                          for c, p, b in reqs], ServeConfig(**kw))
    return jout, pout, jeng.last_stats, peng.last_stats


def _assert_same(jout, pout, jst, pst, reqs):
    for (_, _, budget), a, b in zip(reqs, jout, pout):
        assert len(b) == budget
        np.testing.assert_array_equal(b, a)
    for k in COUNTERS:
        assert pst[k] == jst[k], (k, pst[k], jst[k])


def _requests(vocab, n, clients, seed=0, lo=5, hi=23):
    rng = np.random.default_rng(seed)
    return [(f"c{i % clients}",
             rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32),
             int(rng.integers(3, 9))) for i in range(n)]


def _prefix_requests(vocab, clients, per_client, prefix_len, seed=0):
    """Each client's requests share that client's own prefix."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, prefix_len).astype(np.int32)
                for _ in range(clients)]
    out = []
    for j in range(per_client):
        for c in range(clients):
            tail = rng.integers(0, vocab, int(rng.integers(2, 7)))
            out.append((f"c{c}", np.concatenate(
                [prefixes[c], tail.astype(np.int32)]), 6))
    return out


def _repetitive_requests(vocab, n, clients, seed=0):
    """Prompts built from a repeated motif, so prompt-lookup drafts exist
    and are sometimes accepted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(0, vocab, int(rng.integers(3, 6)))
        p = np.tile(motif, 4)[:int(rng.integers(10, 19))].astype(np.int32)
        out.append((f"c{i % clients}", p, 8))
    return out


def test_lora_scale_is_the_models_not_the_registrys(base):
    """A registry at rank 8 on a config with ``lora_rank`` 4: the engine
    serves with α / cfg.lora_rank as the reference does, not α / 8.
    First-chunk logits at each engine's scale and greedy streams equal the
    reference's."""
    jcfg, pcfg, jm, jp, pp = base
    assert jcfg.lora_rank != 8
    engines = _engines(base, [None, None], capacity=2, rank=8)
    jeng, peng = engines
    assert peng.scale == jeng.scale == jcfg.lora_alpha / jcfg.lora_rank
    reqs = _requests(jcfg.vocab_size, 3, 2, seed=3)
    T = 6
    toks = np.zeros((2, T), np.int32)
    n_new = np.asarray([T, 4], np.int32)
    for i in range(2):
        toks[i, :n_new[i]] = reqs[i][1][:n_new[i]]
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    lens = np.zeros((2,), np.int32)
    ids = np.asarray([jeng.registry.acquire("c0"),
                      jeng.registry.acquire("c1")], np.int32)
    lj, _ = jm.prefill_step(jp, jm.init_paged_decode_cache(2, 6, 4),
                            jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(n_new),
                            adapters=jeng.registry.bank(),
                            lora_scale=jeng.scale,
                            adapter_ids=jnp.asarray(ids),
                            block_tables=jnp.asarray(bt))
    lp, _ = peng.model.prefill_step(
        pp, peng.model.init_paged_decode_cache(6, 4), torch.from_numpy(toks),
        torch.from_numpy(lens), torch.from_numpy(n_new),
        adapters=peng.registry.bank(), lora_scale=peng.scale,
        adapter_ids=torch.from_numpy(ids), block_tables=torch.from_numpy(bt))
    valid = np.arange(T)[None, :] < n_new[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], np.asarray(lj)[valid],
                               atol=1e-4)
    jout, pout, jst, pst = _run(engines, reqs, batch_size=2, block_size=4,
                                prefill_chunk=6)
    _assert_same(jout, pout, jst, pst, reqs)


def test_int8_kv_under_preemption_matches_reference_int8(base):
    """int8 K/V pools with a pool small enough that both engines preempt:
    the port's int8 streams equal the REFERENCE's int8 streams."""
    jcfg = base[0]
    engines = _engines(base, [None] * 3, capacity=4)
    reqs = _requests(jcfg.vocab_size, 6, 3)
    jout, pout, jst, pst = _run(engines, reqs, batch_size=3,
                                max_new_tokens=8, block_size=4,
                                num_blocks=12, prefill_chunk=6,
                                kv_dtype="int8")
    assert pst["preemptions"] > 0
    _assert_same(jout, pout, jst, pst, reqs)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_ragged_int8_bank_mixed_ranks_matches_reference(base, kv_dtype):
    """A ragged int8 bank (buckets 2, 4, 8) with clients at native ranks
    1, 2, 3, 4 and 8 (padded into their buckets), mixed in each batch."""
    jcfg = base[0]
    engines = _engines(base, [1, 2, 3, 4, 8], capacity=7, ranks=[2, 4, 8],
                       bank_dtype="int8")
    reqs = _requests(jcfg.vocab_size, 7, 5, seed=4)
    jout, pout, jst, pst = _run(engines, reqs, batch_size=4,
                                max_new_tokens=8, block_size=4,
                                prefill_chunk=5, kv_dtype=kv_dtype)
    _assert_same(jout, pout, jst, pst, reqs)


def test_prefix_cache_warm_equals_cold_and_reference(base):
    """Per-client shared prefixes with a pinned pool: the cold call hits
    inside itself, the warm call reuses the pool across calls and hits
    more; streams are bitwise warm == cold inside the port and equal to the
    reference's, with equal hit counters.  A kv_dtype change does not
    reuse the warm pool (in either package)."""
    jcfg = base[0]
    engines = _engines(base, [None] * 2, capacity=2)
    reqs = _prefix_requests(jcfg.vocab_size, 2, 3, prefix_len=9)
    kw = dict(batch_size=2, block_size=4, num_blocks=24, prefill_chunk=4,
              prefix_cache=True, kv_dtype="int8")
    cold = _run(engines, reqs, **kw)
    warm = _run(engines, reqs, **kw)
    _assert_same(*cold, reqs)
    _assert_same(*warm, reqs)
    assert cold[3]["prefix_hit_tokens"] > 0
    assert not cold[3]["prefix_pool_reused"]
    assert warm[3]["prefix_pool_reused"]
    assert warm[3]["prefix_hit_tokens"] > cold[3]["prefix_hit_tokens"]
    for a, b in zip(cold[1], warm[1]):
        np.testing.assert_array_equal(a, b)
    other = _run(engines, reqs, **{**kw, "kv_dtype": "f32"})
    _assert_same(*other, reqs)
    assert not other[3]["prefix_pool_reused"]
    # release drops the warm pool
    engines[1].release_prefix_cache()
    engines[1].generate([Request(c, p, max_new_tokens=b)
                         for c, p, b in reqs], ServeConfig(**kw))
    assert not engines[1].last_stats["prefix_pool_reused"]


@pytest.mark.parametrize("case", ["preemption", "warm_prefix"])
def test_spec_decode_matches_reference_and_sequential(base, case):
    """Greedy speculative decoding under preemption, and on a warm prefix
    cache: streams equal the reference's, with equal verify, acceptance
    and rollback counters, and equal the port's own sequential streams."""
    jcfg = base[0]
    engines = _engines(base, [None] * 3, capacity=3)
    reqs = _repetitive_requests(jcfg.vocab_size, 6, 3, seed=5)
    if case == "preemption":
        kw = dict(batch_size=3, block_size=4, num_blocks=14, prefill_chunk=6,
                  spec_decode=True, spec_k=3)
    else:
        kw = dict(batch_size=3, block_size=4, num_blocks=40, prefill_chunk=6,
                  spec_decode=True, spec_k=3, prefix_cache=True,
                  kv_dtype="int8")
        _run(engines, reqs, **kw)                     # warms both pools
    jout, pout, jst, pst = _run(engines, reqs, **kw)
    _assert_same(jout, pout, jst, pst, reqs)
    assert pst["verify_dispatches"] > 0 and pst["accepted_tokens"] > 0
    if case == "preemption":
        assert pst["preemptions"] > 0
    else:
        assert pst["prefix_pool_reused"] and pst["prefix_hit_tokens"] > 0
    seq = engines[1].generate([Request(c, p, max_new_tokens=b)
                               for c, p, b in reqs],
                              ServeConfig(**{**kw, "spec_decode": False}))
    for a, b in zip(seq, pout):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec_ngram", [1, 2])
def test_spec_ngram_reaches_the_drafter(base, spec_ngram):
    """``ServeConfig.spec_ngram`` (the longest history n-gram the drafter
    matches) reaches the port's scheduler as it does the reference's: on
    the preemption workload above, streams and the verify, acceptance and
    rollback counters equal the reference engine's at each value."""
    jcfg = base[0]
    engines = _engines(base, [None] * 3, capacity=3)
    reqs = _repetitive_requests(jcfg.vocab_size, 6, 3, seed=5)
    kw = dict(batch_size=3, block_size=4, num_blocks=14, prefill_chunk=6,
              spec_decode=True, spec_k=3)
    jout, pout, jst, pst = _run(engines, reqs, spec_ngram=spec_ngram, **kw)
    _assert_same(jout, pout, jst, pst, reqs)
    assert pst["verify_dispatches"] > 0
    assert engines[1].session(ServeConfig(spec_ngram=spec_ngram, **kw)
                              ).sched.spec_ngram == spec_ngram


def test_spec_decode_option_checks(base):
    engines = _engines(base, [None], capacity=1)
    reqs = [Request("c0", np.arange(6, dtype=np.int32))]
    with pytest.raises(ValueError, match="greedy-only"):
        engines[1].generate(reqs, ServeConfig(batch_size=1, spec_decode=True,
                                              temperature=0.5))
    with pytest.raises(ValueError, match="spec_k"):
        engines[1].generate(reqs, ServeConfig(batch_size=1, spec_decode=True,
                                              spec_k=0))
    with pytest.raises(ValueError, match="kv_dtype"):
        engines[1].generate(reqs, ServeConfig(batch_size=1, kv_dtype="fp8"))


def test_bank_is_resnapshot_when_the_epoch_moves(base):
    """A registration between rounds of a live session moves bank_epoch;
    the next round re-snapshots the bank (the ragged kernel view is built
    per epoch) and counts the refresh."""
    jcfg = base[0]
    _, peng = _engines(base, [2, 4], capacity=4, ranks=[2, 4])
    ses = peng.session(ServeConfig(batch_size=2, block_size=4,
                                   num_blocks=20, max_new_tokens=4))
    ses.submit(Request("c0", np.arange(1, 9, dtype=np.int32)))
    ses.step()
    peng.registry.register("c1", bridge.adapters_from_jax(
        _tree(jcfg, 7, 4), device="cpu"))
    while ses.has_work:
        ses.step()
    assert ses.finalize()["adapter_bank_refreshes"] == 1
    assert dataclasses.asdict(ServeConfig(batch_size=1))["spec_k"] == 4


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_kv_bytes_per_block_matches_reference(kv_dtype):
    from repro.serving.kv_cache import kv_bytes_per_block as j_bytes
    from repro_torch.serving.kv_cache import kv_bytes_per_block
    for bs, kv, hd in ((16, 32, 128), (4, 2, 16)):
        assert kv_bytes_per_block(bs, kv, hd, kv_dtype) == j_bytes(
            bs, kv, hd, kv_dtype)

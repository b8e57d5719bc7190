"""The port's sharded serving (``serving/sharded.py``) against the reference
package (CPU).

Unit cases port ``tests/test_sharded_serving.py`` case for case (the
host-mesh case needs two devices and a mesh, which the port does not
serve): slot and block translation, per-shard allocators behind one device
view, adapter homing, bank concatenation, round negotiation.  End to end,
on the same weights, adapters and requests (greedy, fp32): the port's
streams at 2 shards equal the JAX engine's at 2 shards and the port's at 1
shard, bitwise, with warm prefix reuse and speculative decoding, and
``shard_placements`` equal the JAX engine's; int8 K/V sharded streams equal
the JAX engine's int8 sharded streams.  Also the sharded cases of
``tests/test_online_update.py`` (hot-swap), ``tests/test_ragged_rank.py``,
``tests/test_quant.py`` and ``tests/test_trace_serving.py`` (overlap on ==
off at two shards), the kernel view of a sharded ragged int8 bank slot by
slot, and the warm-pool key's shard count.
"""

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
from repro.serving.sharded import ShardedAdapterRegistry as JShardedRegistry
from repro.serving.sharded import ShardedPagedKVCache as JShardedKV
from repro.serving.trace import run_trace as j_run_trace
from repro_torch import bridge
from repro_torch.core.lora import tree_leaves
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.sharded import (ShardedAdapterRegistry,
                                         ShardedPagedKVCache,
                                         ShardedScheduler)
from repro_torch.serving.trace import run_trace, synth_trace

VOCAB = 300


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(n, seed=0):
    return (np.arange(n, dtype=np.int32) * 3 + seed) % VOCAB


def _tree(jcfg, seed, rank=None, scale=0.1):
    """A numpy-seeded adapter tree in the reference's layout (non-zero B)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * scale).astype(np.float32),
        tmpl)


@pytest.fixture(scope="module")
def base():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    pcfg = bridge.config_from_jax(jcfg)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, pcfg, jm, jp, pp


def _registries(base, clients, capacity, num_shards=None, **kw):
    """A reference and a port registry (sharded when ``num_shards``) with
    ``clients`` = {client_id: (seed, rank)} registered in order."""
    jcfg, pcfg = base[0], base[1]
    if num_shards is None:
        from repro.serving.registry import AdapterRegistry as JRegistry
        jreg = JRegistry(jcfg, capacity=capacity, **kw)
        reg = AdapterRegistry(pcfg, capacity=capacity, device="cpu", **kw)
    else:
        jreg = JShardedRegistry(jcfg, capacity=capacity,
                                num_shards=num_shards, **kw)
        reg = ShardedAdapterRegistry(pcfg, capacity=capacity,
                                     num_shards=num_shards, device="cpu",
                                     **kw)
    for cid, (seed, rank) in clients.items():
        tree = _tree(jcfg, seed, rank)
        jreg.register(cid, jax.tree.map(jnp.asarray, tree))
        reg.register(cid, bridge.adapters_from_jax(tree, device="cpu"))
    return jreg, reg


def _engines(base, jreg, reg):
    jcfg, pcfg, jm, jp, pp = base
    return (JEngine(jm, jcfg, jp, jreg),
            MultiTenantEngine(Model(pcfg, device="cpu"), pcfg, pp, reg))


# ---------------------------------------------------------------------------
# ShardedPagedKVCache: geometry, translation, disjointness
# ---------------------------------------------------------------------------

def test_sharded_kv_geometry_validation():
    with pytest.raises(ValueError, match="num_shards"):
        ShardedPagedKVCache(0, 4, 4, 17, 4)
    with pytest.raises(ValueError, match="num_slots"):
        ShardedPagedKVCache(2, 3, 4, 17, 4)
    with pytest.raises(ValueError, match="allocatable blocks"):
        ShardedPagedKVCache(2, 4, 4, 18, 4)   # 17 allocatable, odd


def test_sharded_kv_slot_translation_roundtrip():
    kv = ShardedPagedKVCache(3, 6, 4, 1 + 3 * 4, 4)
    for g in range(6):
        s, local = kv.shard_of_slot(g)
        assert kv.global_slot(s, local) == g
        assert 0 <= s < 3 and 0 <= local < 2


def test_sharded_kv_device_tables_translate_into_disjoint_slices():
    """Each shard's table entries map into its own global block slice;
    block 0 stays the shared scratch id everywhere.  The same admissions
    give the reference's global tables."""
    kv = ShardedPagedKVCache(2, 4, 4, 1 + 2 * 6, 4)
    jkv = JShardedKV(2, 4, 4, 1 + 2 * 6, 4)
    for pool in (kv, jkv):
        for g in range(4):
            s, local = pool.shard_of_slot(g)
            pool.shards[s].admit(local, None, _prompt(4, g))
            pool.shards[s].ensure(local, 8)
    tables, lengths = kv.device_tables("cpu")
    jt, jl = jkv.device_tables()
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    tables = tables.numpy()
    assert tables.shape[0] == 4 and lengths.shape == (4,)
    kv.check_invariants()
    used = tables[tables > 0]
    assert used.size == 8                        # 2 blocks per slot
    assert len(set(used.tolist())) == used.size  # globally disjoint
    lo, hi = used[:4], used[4:]                  # shard 0 rows, shard 1 rows
    assert lo.max() <= 6 and hi.min() >= 7       # per-shard slices


def test_sharded_kv_device_tables_are_snapshots():
    """The host mutates its tables in place while a dispatched chunk may
    still read the tensors it was handed."""
    kv = ShardedPagedKVCache(2, 2, 4, 1 + 2 * 4, 4)
    kv.shards[1].admit(0, None, _prompt(4))
    kv.shards[1].ensure(0, 4)
    tables, lengths = kv.device_tables("cpu")
    before = tables.clone()
    kv.shards[1].ensure(0, 8)
    kv.shards[1].lengths[0] = 5
    torch.testing.assert_close(tables, before, rtol=0, atol=0)
    assert int(lengths[1]) == 0


def test_sharded_kv_aggregates_sum_over_shards():
    kv = ShardedPagedKVCache(2, 4, 4, 1 + 2 * 6, 4)
    assert kv.free_blocks == 12 and kv.allocatable_blocks == 12
    assert kv.idle
    v0 = kv.table_version
    kv.shards[0].admit(0, None, _prompt(4))
    kv.shards[0].ensure(0, 4)
    assert kv.free_blocks == 11 and not kv.idle
    assert kv.table_version > v0
    assert kv.fits(4)


def test_best_prefix_shard_finds_the_sealing_shard():
    kv = ShardedPagedKVCache(2, 4, 4, 1 + 2 * 6, 6, prefix_cache=True)
    toks = _prompt(9)
    pool = kv.shards[1]
    pool.admit(0, "c0", toks)
    pool.ensure(0, 9)
    pool.advance(0, 9, tokens=toks)              # seals two full blocks
    pool.release(0)
    assert kv.best_prefix_shard("c0", toks) == (1, 8)
    assert kv.best_prefix_shard("other", toks) == (None, 0)


# ---------------------------------------------------------------------------
# ShardedAdapterRegistry: homing, global slots, bank concatenation
# ---------------------------------------------------------------------------

FOUR = {f"c{i}": (i + 1, None) for i in range(4)}


def test_sharded_registry_capacity_validation(base):
    pcfg = base[1]
    with pytest.raises(ValueError, match="capacity"):
        ShardedAdapterRegistry(pcfg, capacity=3, num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        ShardedAdapterRegistry(pcfg, capacity=4, num_shards=0, device="cpu")


def test_sharded_registry_homes_balance_and_global_slots(base):
    jreg, reg = _registries(base, FOUR, 4, num_shards=2)
    # fewest-resident homing alternates shards; global slot = shard*2+local
    assert [reg.shard_of(f"c{i}") for i in range(4)] == [0, 1, 0, 1]
    slots = {c: reg.acquire(c) for c in FOUR}
    assert sorted(slots.values()) == [0, 1, 2, 3]
    assert slots == {c: jreg.acquire(c) for c in FOUR}
    assert len(reg) == 4 and "c0" in reg
    assert reg.device == torch.device("cpu")
    with pytest.raises(KeyError, match="not resident"):
        reg.acquire("stranger")


def test_sharded_registry_bank_matches_flat_registry(base):
    """The concatenated bank at a client's GLOBAL slot holds the values a
    flat registry serves at its slot, and the reference's sharded bank's
    (period axis dropped)."""
    jreg, sharded = _registries(base, FOUR, 4, num_shards=2)
    _, flat = _registries(base, FOUR, 4)
    fb, sb = dict(tree_leaves(flat.bank())), dict(tree_leaves(sharded.bank()))
    jb = bridge.adapters_from_jax(jax.tree.map(np.asarray, jreg.bank()),
                                  device="cpu")
    assert all(t.shape[0] == 4 for t in sb.values())
    for c in FOUR:
        fs, ss = flat.acquire(c), sharded.acquire(c)
        for path, leaf in sb.items():
            torch.testing.assert_close(leaf[ss], fb[path][fs], rtol=0,
                                       atol=0)
    for path, leaf in tree_leaves(jb):
        torch.testing.assert_close(sb[path], leaf, rtol=0, atol=0)


def test_sharded_registry_evicts_within_home_shard(base):
    _, reg = _registries(base, FOUR, 4, num_shards=2)
    extra = bridge.adapters_from_jax(_tree(base[0], 9), device="cpu")
    # both shards full; c4 homes to shard 0 (tie, lowest index) and its
    # LRU client c0 is evicted THERE; shard 1's residents stay
    slot = reg.register("c4", extra)
    assert reg.shard_of("c4") == 0 and slot in (0, 1)
    assert "c0" not in reg and reg.shard_of("c0") is None
    assert all(c in reg for c in ("c1", "c2", "c3", "c4"))
    assert reg.evictions == 1
    reg.evict("c4")
    assert "c4" not in reg and len(reg) == 3


def test_sharded_bank_is_built_once_per_epoch(base):
    """``bank()`` concatenates once per ``bank_epoch``; a registration
    builds a new bank, and the snapshot an earlier dispatch holds keeps its
    values."""
    _, reg = _registries(base, FOUR, 4, num_shards=2)
    first = reg.bank()
    assert reg.bank() is first
    leaf = tree_leaves(first)[0][1]
    old = leaf.clone()
    e0 = reg.bank_epoch
    reg.register("c1", bridge.adapters_from_jax(_tree(base[0], 77),
                                                device="cpu"))
    assert reg.bank_epoch == e0 + 1
    second = reg.bank()
    assert second is not first
    torch.testing.assert_close(leaf, old, rtol=0, atol=0)
    assert not torch.equal(tree_leaves(second)[0][1][reg.acquire("c1")],
                           old[reg.acquire("c1")])


# ---------------------------------------------------------------------------
# the kernel view of a sharded ragged int8 bank, slot by slot
# ---------------------------------------------------------------------------

RAGGED = {"c0": (1, 2), "c1": (2, 4), "c2": (3, 8), "c3": (4, 4),
          "c4": (5, 2), "c5": (6, 8), "c6": (7, 4)}


def test_kernel_bank_follows_the_global_slot_order(base):
    """``kernel_bank()`` at every global slot equals ``bank()`` routed
    through ``acquire()``: the client's bucket entry zero-padded to the
    largest rank, its int8 scales, and its native rank as the mask; and
    equals the flat registry's kernel view at the flat slot.  Built per
    shard and laid side by side, slot 1 would hold shard 0's bucket-1
    client instead."""
    kw = dict(ranks=[2, 4, 8], bank_dtype="int8")
    _, reg = _registries(base, RAGGED, 12, num_shards=2, **kw)
    _, flat = _registries(base, RAGGED, 12, **kw)
    bank, view, fview = reg.bank(), reg.kernel_bank(), flat.kernel_bank()
    sizes = [2 * n for n in reg.shards[0].bucket_sizes]  # every shard's
    offs = np.cumsum([0] + sizes)
    ranks = reg.slot_ranks()
    r_max = reg.bucket_ranks[-1]
    for cid, (_, native) in RAGGED.items():
        g = reg.acquire(cid)
        b = int(np.searchsorted(offs, g, side="right") - 1)
        local = g - offs[b]
        assert ranks[g] == native
        for i, layer in enumerate(view["layers"]):
            for part, tmap in layer.items():
                for t, kv in tmap.items():
                    node = bank["layers"][i][part][t]
                    rb = node["a"][b].shape[-1]
                    a, bb = kv["a"][g], kv["b"][g]
                    torch.testing.assert_close(a[:, :rb], node["a"][b][local],
                                               rtol=0, atol=0)
                    torch.testing.assert_close(bb[:rb], node["b"][b][local],
                                               rtol=0, atol=0)
                    assert a.shape[-1] == r_max and not a[:, rb:].any()
                    assert not bb[rb:].any()
                    assert kv["a_scale"][g] == node["a_scale"][b][local]
                    assert kv["b_scale"][g] == node["b_scale"][b][local]
                    assert int(kv["ranks"][g]) == native
                    fk = fview["layers"][i][part][t]
                    f = flat.acquire(cid)
                    torch.testing.assert_close(a, fk["a"][f], rtol=0, atol=0)
                    torch.testing.assert_close(bb, fk["b"][f], rtol=0,
                                               atol=0)
                    assert kv["a_scale"][g] == fk["a_scale"][f]
    assert reg.kernel_bank() is view                   # once per epoch


def test_kernel_view_routes_rows_as_the_bank_lists(base):
    """The batched kernel's plain version over the sharded kernel view
    equals the torch path's per-bucket routing over ``bank()``, row by row
    (one projection, every client, int8 ragged buckets)."""
    kw = dict(ranks=[2, 4, 8], bank_dtype="int8")
    _, reg = _registries(base, RAGGED, 12, num_shards=2, **kw)
    pcfg = base[1]
    rng = np.random.default_rng(5)
    ids = torch.as_tensor([reg.acquire(c) for c in RAGGED], dtype=torch.int32)
    x = torch.as_tensor(rng.standard_normal((len(RAGGED), 3, pcfg.d_model)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((pcfg.d_model, pcfg.d_model)),
                        dtype=torch.float32)
    node = reg.bank()["layers"][1]["mixer"]["wq"]
    want = L.dense(x, w, L.lora_pair({"wq": node}, "wq"), 2.0, ids, "torch")
    got = kernel_ops.batched_lora_dense(
        x, w, reg.kernel_bank()["layers"][1]["mixer"]["wq"], ids, 2.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded cases of the ragged-rank and quant suites
# ---------------------------------------------------------------------------

def test_sharded_register_dual_rank_mismatch_names_leaf(base):
    jcfg, pcfg = base[0], base[1]
    reg = ShardedAdapterRegistry(pcfg, capacity=4, num_shards=2,
                                 ranks=[4, 8], device="cpu")
    p = bridge.adapters_from_jax(_tree(jcfg, 1, 4), device="cpu")
    g = bridge.adapters_from_jax(_tree(jcfg, 2, 4), device="cpu")
    pair = g["layers"][0]["mixer"]["wq"]
    pair["a"] = torch.nn.functional.pad(pair["a"], (0, 4))
    pair["b"] = torch.nn.functional.pad(pair["b"], (0, 0, 0, 4))
    with pytest.raises(ValueError,
                       match=r"equal LoRA rank per target.*rank 4.*rank 8"):
        reg.register_dual("c", p, g, [0.5, 0.5])


def test_sharded_version_unregistered_raises_naming_residents(base):
    ad = bridge.adapters_from_jax(_tree(base[0], 1), device="cpu")
    reg = ShardedAdapterRegistry(base[1], capacity=4, num_shards=2,
                                 device="cpu")
    reg.register("alice", ad)
    with pytest.raises(KeyError, match=r"never registered.*alice"):
        reg.version("ghost")
    assert reg.version("alice") == 1
    reg.evict("alice")
    assert reg.version("alice") == 1             # history survives eviction


def test_sharded_version_monotone_across_shard_moves(base):
    """A client churned off one shard and re-placed (possibly on another
    shard) keeps a MONOTONE version: per-shard counters would restart at 1
    and resurrect stale prefix-cache entries."""
    ad = bridge.adapters_from_jax(_tree(base[0], 1), device="cpu")
    reg = ShardedAdapterRegistry(base[1], capacity=2, num_shards=2,
                                 device="cpu")
    reg.register("c0", ad)
    assert reg.version("c0") == 1
    reg.evict("c0")
    reg.register("other", ad)                    # takes a slot somewhere
    reg.register("c0", ad)                       # re-placed
    assert reg.version("c0") == 2


def test_sharded_ragged_global_slots(base):
    reg = ShardedAdapterRegistry(base[1], capacity=8, num_shards=2,
                                 ranks=[4, 8], device="cpu")
    jreg = JShardedRegistry(base[0], capacity=8, num_shards=2, ranks=[4, 8])
    assert reg.ragged and reg.bucket_ranks == [4, 8]
    np.testing.assert_array_equal(reg.slot_ranks(),
                                  [4, 4, 4, 4, 8, 8, 8, 8])
    slots = []
    for i in range(4):
        tree = _tree(base[0], i, [4, 8][i % 2])
        slots.append(reg.register(
            f"c{i}", bridge.adapters_from_jax(tree, device="cpu")))
        assert jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree)) \
            == slots[-1]
    assert len(set(slots)) == 4
    for i, s in enumerate(slots):
        assert reg.slot_ranks()[s] == [4, 8][i % 2]
        assert reg.acquire(f"c{i}") == s
    # per-bucket list leaves, each bucket num_shards * bucket_size clients
    a0 = reg.bank()["layers"][0]["mixer"]["wq"]["a"]
    assert len(a0) == 2 and a0[0].shape[0] == 4 and a0[1].shape[0] == 4


def test_sharded_registry_int8_bank_concat(base):
    jcfg = base[0]
    reg = ShardedAdapterRegistry(base[1], capacity=4, num_shards=2,
                                 bank_dtype="int8", device="cpu")
    jreg = JShardedRegistry(jcfg, capacity=4, num_shards=2,
                            bank_dtype="int8")
    for i in range(3):
        tree = _tree(jcfg, i)
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
    tgt = reg.bank()["layers"][0]["mixer"]["wq"]
    assert tgt["a"].shape[0] == 4 and tgt["a_scale"].shape[0] == 4
    assert tgt["a"].dtype == torch.int8
    jt = jreg.bank()["blocks"]["b0"]["mixer"]["wq"]
    np.testing.assert_array_equal(tgt["a"].numpy(), np.asarray(jt["a"][0]))
    np.testing.assert_allclose(tgt["a_scale"].numpy(),
                               np.asarray(jt["a_scale"][0]), rtol=1e-6)


# ---------------------------------------------------------------------------
# ShardedScheduler: round negotiation
# ---------------------------------------------------------------------------

def test_negotiated_decode_steps_is_min_over_shards():
    """A decode round's step count is the min over per-shard plans, so no
    slot on any shard overshoots its budget inside a fused chunk."""
    kv = ShardedPagedKVCache(2, 2, 4, 17, 8)
    sched = ShardedScheduler(kv)
    sched.shards[0].submit(0, "a", _prompt(4), 10)   # plans a deep chunk
    sched.shards[1].submit(1, "b", _prompt(4), 2)    # nearly done
    sched.admit()
    plan = sched.prepare_chunk(8, 8)
    assert plan == ("prefill", None)                 # both still prefilling
    arrs = sched.prefill_arrays(8)
    sched.observe_prefill(arrs["n_new"], np.ones((2,), np.int32))
    plan = sched.prepare_chunk(8, 8)
    assert plan[0] == "decode"
    assert plan[1] == sched.shards[1].plan_steps(8) == 1


def test_mixed_readiness_forces_global_prefill_round():
    """One shard mid-prompt holds the other (already decoding) shard in
    prefill-shaped rounds, its rows riding as 1-token feedback, until the
    prompt is fed; decoding still advances every round."""
    kv = ShardedPagedKVCache(2, 2, 4, 17, 8)
    sched = ShardedScheduler(kv)
    sched.shards[0].submit(0, "a", _prompt(12), 4)   # 3 prefill chunks of 4
    sched.shards[1].submit(1, "b", _prompt(2), 6)    # prefills in one
    sched.admit()
    rounds = []
    while sched.has_work:
        plan = sched.prepare_chunk(4, 4)
        rounds.append(plan[0])
        K = kv.num_slots
        if plan[0] == "prefill":
            arrs = sched.prefill_arrays(4)
            sched.observe_prefill(arrs["n_new"], np.ones((K,), np.int32))
        else:
            sched.chunk_arrays()
            sched.observe_chunk(np.ones((plan[1], K), np.int32))
    assert rounds[:3] == ["prefill"] * 3             # shard 0's prompt wins
    assert sched.results[0].size == 4 and sched.results[1].size == 6


def test_prompt_only_prefill_chunk_observes_without_samples():
    """A chunk in which no shard emits is never read back: the engine hands
    ``observe_prefill`` None, and each shard gets None."""
    kv = ShardedPagedKVCache(2, 2, 4, 17, 8)
    sched = ShardedScheduler(kv)
    sched.submit(0, "a", _prompt(12), 4)
    sched.submit(1, "b", _prompt(12), 4)
    sched.admit()
    assert sched.prepare_chunk(4, 4) == ("prefill", None)
    arrs = sched.prefill_arrays(4)
    assert not sched.chunk_emits(arrs["n_new"])
    assert sched.observe_prefill(arrs["n_new"], None) == []


# ---------------------------------------------------------------------------
# The engine: num_shards=2 is bitwise the single pool, and the JAX engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_engines(base):
    return _engines(base, *_registries(base, FOUR, 4, num_shards=2))


def _mixed_requests(n=8):
    rng = np.random.default_rng(11)
    reqs = [("c0", _prompt(12), 6)]
    for i in range(n - 1):
        plen = int(rng.integers(2, 13))
        reqs.append((f"c{i % 4}",
                     rng.integers(0, VOCAB, plen).astype(np.int32),
                     int(rng.integers(2, 7))))
    return reqs


def _sc(**kw):
    base = dict(batch_size=4, max_new_tokens=6, block_size=4,
                num_blocks=25, prefill_chunk=4)
    base.update(kw)
    return base


def _gen(eng, reqs, kw, jax_side=False):
    if jax_side:
        return eng.generate([JRequest(c, p, max_new_tokens=b)
                             for c, p, b in reqs], JServeConfig(**kw))
    return eng.generate([Request(c, p, max_new_tokens=b)
                         for c, p, b in reqs], ServeConfig(**kw))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("extra", [{}, {"spec_decode": True}],
                         ids=["plain", "spec_decode"])
def test_engine_two_shards_bitwise_equals_single_pool_and_reference(
        sharded_engines, extra):
    """Sharding re-partitions host bookkeeping only: greedy streams at
    num_shards 1 and 2 are bitwise equal, and equal the JAX engine's at 2
    shards, with the same scheduler counters."""
    jeng, peng = sharded_engines
    reqs = _mixed_requests()
    one = _gen(peng, reqs, _sc(num_shards=1, **extra))
    two = _gen(peng, reqs, _sc(num_shards=2, **extra))
    st = peng.last_stats
    assert st["num_shards"] == 2
    want = _gen(jeng, reqs, _sc(num_shards=2, **extra), jax_side=True)
    _equal(one, two)
    _equal(two, want)
    for k in ("prefill_dispatches", "decode_dispatches", "verify_dispatches",
              "accepted_tokens", "preemptions", "shard_placements"):
        assert st[k] == jeng.last_stats[k], k
    if extra:
        assert st["verify_dispatches"] > 0


def test_engine_sharded_reports_placements_and_uses_both_shards(
        sharded_engines):
    jeng, peng = sharded_engines
    _gen(peng, _mixed_requests(), _sc(num_shards=2))
    st = peng.last_stats
    assert st["num_shards"] == 2
    placed = st["shard_placements"]
    assert set(placed) == {"prefix", "adapter", "load"}
    # every client has a resident adapter: affinity drove intake
    assert placed["adapter"] == 8 and placed["prefix"] == 0
    assert st["deferred_chunks"] == 0          # no deferral across shards


def test_engine_sharded_warm_prefix_reuse_is_bitwise(sharded_engines):
    """Warm cross-call reuse through the sharded pool: the second call
    re-matches blocks sealed by the first (prefix placements appear),
    stays bitwise equal to the cold stream, and both equal the JAX
    engine's cold and warm streams."""
    jeng, peng = sharded_engines
    reqs = _mixed_requests(n=6)
    kw = _sc(num_shards=2, prefix_cache=True)
    runs = {}
    for name, eng, jside in (("port", peng, False), ("jax", jeng, True)):
        eng.release_prefix_cache()
        cold = _gen(eng, reqs, kw, jside)
        warm = _gen(eng, reqs, kw, jside)
        runs[name] = (cold, warm, eng.last_stats)
        eng.release_prefix_cache()
    cold, warm, st = runs["port"]
    assert st["prefix_pool_reused"] and st["prefix_hit_tokens"] > 0
    assert st["shard_placements"]["prefix"] > 0
    assert st["shard_placements"] == runs["jax"][2]["shard_placements"]
    assert st["prefix_hit_tokens"] == runs["jax"][2]["prefix_hit_tokens"]
    _equal(cold, warm)
    _equal(cold, runs["jax"][0])
    _equal(warm, runs["jax"][1])


def test_engine_sharded_geometry_validation(sharded_engines):
    _, peng = sharded_engines
    reqs = _mixed_requests(n=2)
    with pytest.raises(ValueError, match="num_shards"):
        _gen(peng, reqs, _sc(num_shards=0))
    with pytest.raises(ValueError, match="batch_size"):
        _gen(peng, reqs, _sc(batch_size=3, num_shards=2))
    with pytest.raises(ValueError, match="not divisible"):
        _gen(peng, reqs, _sc(num_shards=2, num_blocks=24))


def test_warm_single_pool_is_not_reused_by_a_sharded_stream(
        sharded_engines):
    """The warm pool's key holds the shard count: a pool kept by a
    single-pool stream has the same slots, blocks and table width as a
    2-shard stream's, but not its tables; it must start cold."""
    _, peng = sharded_engines
    reqs = _mixed_requests(n=6)
    peng.release_prefix_cache()
    single = _gen(peng, reqs, _sc(num_shards=1, prefix_cache=True))
    assert not peng.last_stats["prefix_pool_reused"]
    sharded = _gen(peng, reqs, _sc(num_shards=2, prefix_cache=True))
    assert not peng.last_stats["prefix_pool_reused"]
    assert peng.last_stats["shard_placements"]["prefix"] == 0
    again = _gen(peng, reqs, _sc(num_shards=2, prefix_cache=True))
    assert peng.last_stats["prefix_pool_reused"]
    peng.release_prefix_cache()
    _equal(single, sharded)
    _equal(sharded, again)


@pytest.mark.parametrize("bank", ["f32", "ragged_int8"])
def test_int8_kv_sharded_streams_equal_the_reference_int8(base, bank):
    """int8 K/V at 2 shards (and a ragged int8 bank over a sharded
    registry): the port's streams equal the JAX engine's int8 sharded
    streams (not f32 ones) and the port's int8 single-pool streams."""
    if bank == "f32":
        clients, kw = FOUR, {}
    else:
        clients = {f"c{i}": (i + 1, [2, 4, 8][i % 3]) for i in range(4)}
        kw = dict(ranks=[2, 4, 8], bank_dtype="int8")
    jeng, peng = _engines(base, *_registries(base, clients, 12,
                                             num_shards=2, **kw))
    reqs = _mixed_requests()
    one = _gen(peng, reqs, _sc(num_shards=1, kv_dtype="int8"))
    two = _gen(peng, reqs, _sc(num_shards=2, kv_dtype="int8"))
    assert peng.last_stats["kv_dtype"] == "int8"
    want = _gen(jeng, reqs, _sc(num_shards=2, kv_dtype="int8"),
                jax_side=True)
    _equal(one, two)
    _equal(two, want)


# ---------------------------------------------------------------------------
# hot-swap across shards (tests/test_online_update.py's sharded cases)
# ---------------------------------------------------------------------------

CLIENT_RANKS = {"c0": 2, "c1": 4, "c2": 8}


def _swap_registries(base, shards):
    clients = {c: (i + 1, rk) for i, (c, rk) in
               enumerate(CLIENT_RANKS.items())}
    if shards == 1:
        return _registries(base, clients, 3, ranks=[2, 4, 8])
    return _registries(base, clients, 6, num_shards=2, ranks=[2, 4, 8])


def _drive(mt, reqs, sc, update_at=None, update_fn=None):
    """Step a closed-loop session to completion, firing ``update_fn``
    between rounds ``update_at`` steps in.  Returns (streams, stats)."""
    ses = mt.session(sc, reqs)
    got = {i: [] for i in range(len(reqs))}
    steps = 0
    while ses.has_work:
        for rid, toks, _fin in ses.step():
            got[rid].extend(toks)
        steps += 1
        if update_at is not None and steps == update_at:
            update_fn()
    return got, ses.finalize()


@pytest.mark.parametrize("shards", [1, 2])
def test_hot_swap_untouched_clients_bitwise_stable(base, shards):
    """An online update of c1 lands after round 2: untouched clients'
    streams are bitwise those of the run without it, c1's move, and both
    runs equal the JAX engine's runs with the same update."""
    jcfg = base[0]
    prompt = np.arange(8, dtype=np.int32) % VOCAB
    order = ["c0", "c1", "c2", "c0", "c2", "c1"]
    kw = dict(batch_size=2 * shards, max_new_tokens=6, block_size=4,
              num_blocks=1 + 8 * shards, prefill_chunk=4, num_shards=shards)
    new = _tree(jcfg, 41, CLIENT_RANKS["c1"])
    runs = {}
    for update in (False, True):
        jreg, reg = _swap_registries(base, shards)
        jeng, peng = _engines(base, jreg, reg)
        v0 = reg.version("c1")
        fns = (lambda: reg.register(
                   "c1", bridge.adapters_from_jax(new, device="cpu")),
               lambda: jreg.register("c1", jax.tree.map(jnp.asarray, new)))
        got, st = _drive(peng, [Request(c, prompt) for c in order],
                         ServeConfig(**kw), 2 if update else None, fns[0])
        want, jst = _drive(jeng, [JRequest(c, prompt) for c in order],
                           JServeConfig(**kw), 2 if update else None, fns[1])
        assert got == {k: [int(t) for t in v] for k, v in want.items()}
        assert st["adapter_bank_refreshes"] == jst["adapter_bank_refreshes"]
        assert reg.version("c1") == v0 + int(update)
        runs[update] = (got, st)
    (base_s, st0), (upd, st1) = runs[False], runs[True]
    assert st0["adapter_bank_refreshes"] == 0
    assert st1["adapter_bank_refreshes"] >= 1
    changed = False
    for rid, cid in enumerate(order):
        if cid == "c1":
            changed |= upd[rid] != base_s[rid]
            continue
        assert upd[rid] == base_s[rid], f"untouched {cid} (rid {rid}) drifted"
    assert changed, "the updated client's stream never moved"


# ---------------------------------------------------------------------------
# overlap on == off at two shards (tests/test_trace_serving.py's case)
# ---------------------------------------------------------------------------

def test_trace_overlap_parity_two_shards(base):
    """The reference's open-loop pool at two shards (20 allocatable blocks =
    2 x 10): overlap on and off give bitwise equal streams, and equal the
    JAX engine's run."""
    clients = {"c0": (100, None), "c1": (101, None)}
    jeng, peng = _engines(base, *_registries(base, clients, 4))
    tr = synth_trace(0, 10, arrival="bursty", rate=40.0, prompt_mean=8.0,
                     prompt_max=24, out_mean=6.0, out_max=10)
    kw = dict(batch_size=4, max_new_tokens=12, block_size=8, num_blocks=21,
              max_blocks_per_slot=5, prefill_chunk=4, scan_chunk=4,
              num_shards=2)
    on = run_trace(peng, ServeConfig(**kw), tr, rounds_per_s=6.0)
    off = run_trace(peng, ServeConfig(**kw, overlap=False), tr,
                    rounds_per_s=6.0)
    want = j_run_trace(jeng, JServeConfig(**kw), tr, rounds_per_s=6.0)
    assert on["last_stats"]["num_shards"] == 2
    assert on["completed"] == off["completed"] == len(tr)
    for rep in (off, want):
        assert set(rep["streams"]) == set(on["streams"])
        for rid in on["streams"]:
            assert list(rep["streams"][rid]) == list(on["streams"][rid])
    assert on["last_stats"]["shard_placements"] == \
        want["last_stats"]["shard_placements"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_shards_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "3", "--batch", "4",
          "--requests", "6", "--new-tokens", "3", "--prefill-chunk", "8",
          "--shards", "2"])
    out = capsys.readouterr().out
    assert "3 tenants, 6 ragged requests over 4 slots on cpu" in out
    assert "2 shards: placements {'prefix': 0, 'adapter': 6, 'load': 0}" \
        in out


def test_serve_cli_update_every_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "2", "--batch", "2",
          "--requests", "4", "--new-tokens", "4", "--prefill-chunk", "8",
          "--update-every", "2"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "online updates" in ln)
    n_updates = int(line.split(":")[1].split()[0])
    assert n_updates >= 1 and "bank hot-swaps" in line
    with pytest.raises(SystemExit, match="pick one"):
        main(["--smoke", "--device", "cpu", "--update-every", "2",
              "--prefix-cache"])

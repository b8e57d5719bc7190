"""The port's ``AdapterRegistry`` against the reference registry (CPU).

Same adapter trees (numpy, non-zero B) registered into both: slots, LRU
order, evictions, versions and the stacked banks must agree, with and
without the Eq. 7 merge of ``register_dual``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.serving.registry import AdapterRegistry as JRegistry
from repro_torch import bridge
from repro_torch.core.dual_lora import check_rank_agreement, merge
from repro_torch.core.lora import init_adapters
from repro_torch.serving.registry import AdapterRegistry


def _cfgs():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    return jcfg, bridge.config_from_jax(jcfg)


def _tree(jcfg, seed, rank=None):
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def _assert_banks_equal(jreg, reg):
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, jreg.bank()), device="cpu")
    got = reg.bank()
    for i, (wl, gl) in enumerate(zip(want["layers"], got["layers"])):
        for part in wl:
            for t in wl[part]:
                for f in ("a", "b"):
                    # the same fp32 values copied (and, for register_dual,
                    # merged with the same fp32 arithmetic): bitwise
                    np.testing.assert_array_equal(
                        gl[part][t][f].numpy(), wl[part][t][f].numpy(),
                        err_msg=f"layer {i} {part}/{t}/{f}")


def test_register_evict_lru_and_versions_match_reference():
    jcfg, pcfg = _cfgs()
    jreg = JRegistry(jcfg, capacity=3)
    reg = AdapterRegistry(pcfg, capacity=3, device="cpu")
    ops = [("reg", "a", 1), ("reg", "b", 2), ("reg", "c", 3),
           ("acq", "a", None), ("reg", "d", 4),       # evicts LRU: b
           ("reg", "a", 5),                           # refresh in place
           ("evict", "c", None), ("reg", "e", 6), ("acq", "d", None),
           ("reg", "f", 7)]                           # evicts LRU: a
    for op, cid, seed in ops:
        if op == "reg":
            tree = _tree(jcfg, seed)
            assert (reg.register(cid, bridge.adapters_from_jax(tree, device="cpu"))
                    == jreg.register(cid, jax.tree.map(jnp.asarray, tree)))
        elif op == "acq":
            assert reg.acquire(cid) == jreg.acquire(cid)
        else:
            reg.evict(cid)
            jreg.evict(cid)
        assert reg.resident == jreg.resident
        assert reg.evictions == jreg.evictions
        assert reg.bank_epoch == jreg.bank_epoch
    for cid in ("a", "b", "c", "d", "e", "f"):
        assert reg.version(cid) == jreg.version(cid)
    _assert_banks_equal(jreg, reg)
    with pytest.raises(KeyError):
        reg.acquire("b")
    with pytest.raises(KeyError):
        reg.version("never")


def test_register_dual_bank_matches_reference_eq7():
    jcfg, pcfg = _cfgs()
    jreg = JRegistry(jcfg, capacity=2)
    reg = AdapterRegistry(pcfg, capacity=2, device="cpu")
    w = [0.7, 0.4]
    for i, cid in enumerate(("x", "y")):
        p, g = _tree(jcfg, 10 + i), _tree(jcfg, 20 + i)
        jreg.register_dual(cid, jax.tree.map(jnp.asarray, p),
                           jax.tree.map(jnp.asarray, g), jnp.asarray(w),
                           default_priority="interactive")
        reg.register_dual(cid, bridge.adapters_from_jax(p, device="cpu"),
                          bridge.adapters_from_jax(g, device="cpu"), w,
                          default_priority="interactive")
        assert reg.default_priority(cid) == jreg.default_priority(cid)
    _assert_banks_equal(jreg, reg)
    # the merge itself, leafwise: w1 * p + w2 * g
    p = init_adapters(pcfg, seed=1, device="cpu", b_std=0.1)
    g = init_adapters(pcfg, seed=2, device="cpu", b_std=0.1)
    m = merge(p, g, w)
    a = m["layers"][1]["mlp"]["w_up"]["a"]
    torch.testing.assert_close(a, 0.7 * p["layers"][1]["mlp"]["w_up"]["a"]
                               + 0.4 * g["layers"][1]["mlp"]["w_up"]["a"])


def test_registry_rejects_bad_trees_before_writing():
    jcfg, pcfg = _cfgs()
    reg = AdapterRegistry(pcfg, capacity=2, device="cpu")
    good = bridge.adapters_from_jax(_tree(jcfg, 1), device="cpu")
    wrong_rank = bridge.adapters_from_jax(_tree(jcfg, 2, rank=2), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        reg.register("a", wrong_rank)
    with pytest.raises(ValueError, match="equal LoRA rank"):
        reg.register_dual("a", good, wrong_rank, [0.5, 0.5])
    with pytest.raises(ValueError, match="default_priority"):
        reg.register("a", good, default_priority="urgent")
    missing = bridge.adapters_from_jax(_tree(jcfg, 3), device="cpu")
    del missing["layers"][0]["mixer"]["wq"]
    with pytest.raises(ValueError, match="missing leaves"):
        reg.register("a", missing)
    assert len(reg) == 0 and reg.bank_epoch == 0
    with pytest.raises(ValueError, match="equal LoRA rank"):
        check_rank_agreement(good, wrong_rank)


def test_registry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError, match="is_available"):
        AdapterRegistry(pcfg, capacity=2)              # default: cuda


# ---------------------------------------------------------------------------
# ragged-rank and int8 banks (the reference's tests/test_ragged_rank.py and
# tests/test_quant.py cases, held against the reference registry)
# ---------------------------------------------------------------------------

def _bucket(tree, b):
    """Bucket ``b`` of a ragged bank tree (every list leaf -> element b)."""
    if isinstance(tree, dict):
        return {k: _bucket(v, b) for k, v in tree.items()}
    return tree[b] if isinstance(tree, list) else tree


def _assert_ragged_banks_equal(jreg, reg):
    jb = jax.tree.map(np.asarray, jreg.bank())
    got = reg.bank()
    for b in range(len(reg.bucket_ranks)):
        want = bridge.adapters_from_jax(_bucket(jb, b), device="cpu")
        for i, wl in enumerate(want["layers"]):
            for part in wl:
                for t, leaves in wl[part].items():
                    for f, leaf in leaves.items():
                        g = got["layers"][i][part][t][f][b]
                        assert g.dtype == leaf.dtype, (f, g.dtype)
                        # the same fp32 values padded and quantized by the
                        # same arithmetic: bitwise
                        np.testing.assert_array_equal(
                            g.numpy(), leaf.numpy(),
                            err_msg=f"bucket {b} layer {i} {part}/{t}/{f}")


def _check_same_state(jreg, reg):
    assert reg.resident == jreg.resident
    assert reg.evictions == jreg.evictions
    assert reg.bank_epoch == jreg.bank_epoch
    np.testing.assert_array_equal(reg.slot_ranks(), jreg.slot_ranks())


@pytest.mark.parametrize("bank_dtype", ["f32", "int8"])
def test_ragged_registry_matches_reference(bank_dtype):
    """Smallest-covering-bucket placement with zero rank padding, per-bucket
    LRU eviction, a rank change that moves buckets without an eviction,
    evict and re-register: slots, residency, evictions, epochs, native
    slot ranks, versions and the (int8-quantized) banks equal the
    reference registry's after every operation."""
    jcfg, pcfg = _cfgs()
    kw = dict(capacity=5, ranks=[8, 2, 4], bank_dtype=bank_dtype)
    jreg = JRegistry(jcfg, **kw)
    reg = AdapterRegistry(pcfg, device="cpu", **kw)
    assert (reg.bucket_ranks, reg.bucket_sizes, reg.bucket_offsets) == (
        jreg.bucket_ranks, jreg.bucket_sizes, jreg.bucket_offsets)
    ops = [("reg", "a", 2, 1), ("reg", "b", 3, 2), ("reg", "c", 8, 3),
           ("reg", "d", 1, 4),                  # rank 1 -> bucket rank 2
           ("acq", "a", None, None),
           ("reg", "e", 2, 5),                  # bucket 2 full: evicts d
           ("reg", "a", 8, 6),                  # moves bucket, no eviction
           ("reg", "f", 4, 7), ("evict", "b", None, None),
           ("reg", "g", 4, 8), ("reg", "c", 8, 9)]
    for op, cid, rank, seed in ops:
        if op == "reg":
            tree = _tree(jcfg, seed, rank=rank)
            assert (reg.register(cid, bridge.adapters_from_jax(
                tree, device="cpu"))
                == jreg.register(cid, jax.tree.map(jnp.asarray, tree)))
        elif op == "acq":
            assert reg.acquire(cid) == jreg.acquire(cid)
        else:
            reg.evict(cid)
            jreg.evict(cid)
        _check_same_state(jreg, reg)
    for s in range(reg.capacity):
        assert reg.bucket_of_slot(s) == jreg.bucket_of_slot(s)
    for cid in "abcdefg":
        assert reg.version(cid) == jreg.version(cid)
    _assert_ragged_banks_equal(jreg, reg)


def test_register_dual_and_publish_into_ragged_int8_registry():
    """Eq. 7 fusion at register_dual and the trainer's publish both land in
    a ragged int8 registry exactly as the reference's register_dual."""
    from repro_torch.core.fdlora import ClientState, FDLoRAConfig, FDLoRATrainer
    from repro_torch.models.api import Model
    jcfg, pcfg = _cfgs()
    kw = dict(capacity=4, ranks=[2, 4], bank_dtype="int8")
    jreg = JRegistry(jcfg, **kw)
    reg = AdapterRegistry(pcfg, device="cpu", **kw)
    w = [0.7, 0.4]
    for i, (cid, rank) in enumerate((("x", 2), ("y", 4))):
        p, g = _tree(jcfg, 30 + i, rank), _tree(jcfg, 40 + i, rank)
        jreg.register_dual(cid, jax.tree.map(jnp.asarray, p),
                           jax.tree.map(jnp.asarray, g), jnp.asarray(w))
        reg.register_dual(cid, bridge.adapters_from_jax(p, device="cpu"),
                          bridge.adapters_from_jax(g, device="cpu"), w)
    _check_same_state(jreg, reg)
    _assert_ragged_banks_equal(jreg, reg)
    # publish: the trainer registers merge(personalized, θ_s, w)
    model = Model(pcfg, device="cpu")
    tr = FDLoRATrainer(model, pcfg, FDLoRAConfig(n_clients=1), None,
                       device="cpu")
    p, g = _tree(jcfg, 50, 4), _tree(jcfg, 51, 4)
    tr.theta_s = bridge.adapters_from_jax(g, device="cpu")
    client = ClientState(bridge.adapters_from_jax(p, device="cpu"), None,
                         None, np.asarray(w, np.float32))
    slots = tr.publish(reg, [client], ["z"])
    jslot = jreg.register_dual("z", jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, g), jnp.asarray(w))
    assert slots == {"z": jslot}
    _check_same_state(jreg, reg)
    _assert_ragged_banks_equal(jreg, reg)


def test_ragged_registry_validation_matches_reference():
    jcfg, pcfg = _cfgs()
    for kw, match in (({"rank": 4, "ranks": [2, 4]}, "not both"),
                      ({"ranks": [0, 4]}, "positive"),
                      ({"ranks": [2, 4, 8], "capacity": 2}, "cannot host")):
        kw = {"capacity": 4, **kw}
        with pytest.raises(ValueError, match=match):
            JRegistry(jcfg, **kw)
        with pytest.raises(ValueError, match=match):
            AdapterRegistry(pcfg, device="cpu", **kw)
    reg = AdapterRegistry(pcfg, capacity=2, ranks=[2, 4], device="cpu")
    with pytest.raises(ValueError, match=r"buckets: \[2, 4\]"):
        reg.register("big", bridge.adapters_from_jax(_tree(jcfg, 1, 8),
                                                     device="cpu"))
    mixed = bridge.adapters_from_jax(_tree(jcfg, 2, 2), device="cpu")
    mixed["layers"][1]["mlp"] = bridge.adapters_from_jax(
        _tree(jcfg, 3, 4), device="cpu")["layers"][1]["mlp"]
    with pytest.raises(ValueError, match="mixes LoRA ranks"):
        reg.register("bad", mixed)
    assert len(reg) == 0 and reg.bank_epoch == 0


def test_kernel_bank_is_built_once_per_epoch():
    """The kernel view concatenates the buckets at the largest rank with a
    per-slot rank vector, equal to ``ops.concat_buckets`` of ``bank()``;
    it is rebuilt only when ``bank_epoch`` moves."""
    from repro_torch.kernels.ops import concat_buckets
    jcfg, pcfg = _cfgs()
    reg = AdapterRegistry(pcfg, capacity=3, ranks=[2, 4], bank_dtype="int8",
                          device="cpu")
    reg.register("c", bridge.adapters_from_jax(_tree(jcfg, 1, 2),
                                               device="cpu"))
    view = reg.kernel_bank()
    assert reg.kernel_bank() is view
    node = view["layers"][0]["mixer"]["wq"]
    assert node["ranks"].tolist() == [2, 2, 4]
    want = concat_buckets(reg.bank()["layers"][0]["mixer"]["wq"])
    for k in ("a", "b", "a_scale", "b_scale", "ranks"):
        assert torch.equal(node[k], want[k])
    reg.register("d", bridge.adapters_from_jax(_tree(jcfg, 2, 4),
                                               device="cpu"))
    assert reg.kernel_bank() is not view
    single = AdapterRegistry(pcfg, capacity=2, device="cpu")
    assert single.kernel_bank() is single.bank()

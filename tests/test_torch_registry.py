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
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, jreg.bank()))
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
            assert (reg.register(cid, bridge.adapters_from_jax(tree))
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
        reg.register_dual(cid, bridge.adapters_from_jax(p),
                          bridge.adapters_from_jax(g), w,
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
    good = bridge.adapters_from_jax(_tree(jcfg, 1))
    wrong_rank = bridge.adapters_from_jax(_tree(jcfg, 2, rank=2))
    with pytest.raises(ValueError, match="shape"):
        reg.register("a", wrong_rank)
    with pytest.raises(ValueError, match="equal LoRA rank"):
        reg.register_dual("a", good, wrong_rank, [0.5, 0.5])
    with pytest.raises(ValueError, match="default_priority"):
        reg.register("a", good, default_priority="urgent")
    missing = bridge.adapters_from_jax(_tree(jcfg, 3))
    del missing["layers"][0]["mixer"]["wq"]
    with pytest.raises(ValueError, match="missing leaves"):
        reg.register("a", missing)
    assert len(reg) == 0 and reg.bank_epoch == 0
    with pytest.raises(ValueError, match="equal LoRA rank"):
        check_rank_agreement(good, wrong_rank)


@pytest.mark.parametrize("kw", [{"bank_dtype": "int8"},
                                {"ranks": [2, 4]}])
def test_later_slice_bank_options_raise(kw):
    _, pcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        AdapterRegistry(pcfg, capacity=4, device="cpu", **kw)


def test_registry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError, match="is_available"):
        AdapterRegistry(pcfg, capacity=2)              # default: cuda

"""The port's fixed-batch path and single-tenant ``Engine`` against the
reference package (CPU).

On the same weights and adapters (bridged from numpy seeds) and the same
prompts: ``MultiTenantEngine.generate_fixed`` and ``Engine.generate`` emit
the JAX engines' greedy streams, bitwise (fp32), with EOS / ``pad_id``
padding and through a sliding-window arch whose ``cache_len`` exceeds the
window, so the ring buffer wraps; the contiguous decode step's logits
match the reference's.  Inside the port, as the reference's own tests
hold: a mixed-client batch equals single-tenant decoding per client
(``tests/test_multitenant.py``), a zeroed bank slot equals the base model,
and continuous batching equals the fixed path on equal shapes
(``tests/test_continuous.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import MultiTenantEngine as JMTEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro_torch import bridge
from repro_torch.models.api import Model
from repro_torch.serving.engine import (Engine, MultiTenantEngine, Request,
                                        ServeConfig)
from repro_torch.serving.registry import AdapterRegistry


def _tree(jcfg, seed, scale=0.1):
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * scale).astype(np.float32),
        tmpl)


def _setup(**cfg_kw):
    """(jcfg, pcfg, JAX model, JAX params, port model, port params)."""
    jcfg = tiny_dense(**cfg_kw)
    pcfg = bridge.config_from_jax(jcfg)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, pcfg, jm, jp, Model(pcfg, device="cpu"), pp


@pytest.fixture(scope="module")
def fp32():
    return _setup(dtype="float32", param_dtype="float32")


def _mt_pair(setup, trees):
    jcfg, pcfg, jm, jp, pm, pp = setup
    jreg = JRegistry(jcfg, capacity=4)
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for cid, tree in trees.items():
        jreg.register(cid, jax.tree.map(jnp.asarray, tree))
        reg.register(cid, bridge.adapters_from_jax(tree, device="cpu"))
    return JMTEngine(jm, jcfg, jp, jreg), MultiTenantEngine(pm, pcfg, pp, reg)


def _prompt(vocab, n=8, step=1):
    return (np.arange(n, dtype=np.int32) * step + 1) % vocab


# ---------------------------------------------------------------------------
# against the JAX engines
# ---------------------------------------------------------------------------

def test_contiguous_decode_step_logits_match_the_reference(fp32):
    """Sequential decode steps through the ring-buffer cache: logits equal
    the reference's within fp32 summation noise at every position."""
    jcfg, pcfg, jm, jp, pm, pp = fp32
    tree = _tree(jcfg, 3)
    jad = jax.tree.map(jnp.asarray, tree)
    pad = bridge.adapters_from_jax(tree, device="cpu")
    toks = np.stack([_prompt(jcfg.vocab_size, 10, 3),
                     _prompt(jcfg.vocab_size, 10, 7)])
    jc, pc = jm.init_decode_cache(2, 16), pm.init_decode_cache(2, 16)
    for t in range(toks.shape[1]):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t), adapters=jad, lora_scale=2.0)
        pl, pc = pm.decode_step(pp, pc, torch.as_tensor(toks[:, t:t + 1]),
                                t, adapters=pad, lora_scale=2.0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert pc["layers"][0]["pos"] == toks.shape[1]


def test_init_decode_cache_sizes_the_ring():
    pcfg = bridge.config_from_jax(tiny_dense(sliding_window=8))
    cache = Model(pcfg, device="cpu").init_decode_cache(3, 32)
    k = cache["layers"][0]["k"]
    assert k.shape == (3, 8, pcfg.n_kv_heads, pcfg.resolved_head_dim)
    assert k.dtype == torch.bfloat16 and cache["layers"][0]["pos"] == 0
    full = bridge.config_from_jax(tiny_dense())
    assert Model(full, device="cpu").init_decode_cache(1, 32)["layers"][0][
        "k"].shape[1] == 32


@pytest.mark.parametrize("eos", [False, True], ids=["budget", "eos_pad"])
def test_generate_fixed_equals_the_reference(fp32, eos):
    """A mixed-client fixed batch: streams equal the JAX engine's, bitwise;
    with ``eos_id`` set, rows pad with ``pad_id`` after EOS in both."""
    jcfg = fp32[0]
    jeng, peng = _mt_pair(fp32, {f"c{i}": _tree(jcfg, 10 + i)
                                 for i in range(3)})
    prompt = _prompt(jcfg.vocab_size, 9, 5)
    order = ["c1", "c0", "c2", "c1"]
    kw = dict(batch_size=4, max_new_tokens=10, cache_len=32)
    if eos:
        probe = np.asarray(jeng.generate_fixed(
            [JRequest(c, prompt) for c in order], JServeConfig(**kw)))
        kw.update(eos_id=int(probe[0, 2]), pad_id=7)
    want = np.asarray(jeng.generate_fixed([JRequest(c, prompt)
                                           for c in order],
                                          JServeConfig(**kw)))
    got = peng.generate_fixed([Request(c, prompt) for c in order],
                              ServeConfig(**kw))
    assert got.dtype == torch.int32 and got.shape == (4, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        cut = int(np.flatnonzero(want[0] == kw["eos_id"])[0])
        assert cut < 9 and (want[0, cut + 1:] == 7).all()


@pytest.mark.parametrize("adapter", [False, True],
                         ids=["base_model", "one_adapter"])
def test_engine_generate_equals_the_reference(fp32, adapter):
    jcfg, pcfg, jm, jp, pm, pp = fp32
    tree = _tree(jcfg, 21) if adapter else None
    jeng = JEngine(jm, jcfg, jp,
                   None if tree is None else jax.tree.map(jnp.asarray, tree))
    peng = Engine(pm, pcfg, pp, None if tree is None else
                  bridge.adapters_from_jax(tree, device="cpu"))
    prompts = np.stack([_prompt(jcfg.vocab_size, 7, s) for s in (1, 4, 9)])
    sc = dict(batch_size=3, max_new_tokens=9, cache_len=24)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), JServeConfig(**sc)))
    got = peng.generate(prompts, ServeConfig(**sc))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sliding_window_ring_wraps_and_equals_the_reference():
    """A sliding-window arch with ``cache_len`` past the window: the cache
    is window-sized, so prefill and decode wrap the ring; streams equal the
    reference's, and differ from the same arch without the window."""
    setup = _setup(dtype="float32", param_dtype="float32", sliding_window=6)
    jcfg, pcfg, jm, jp, pm, pp = setup
    jeng, peng = _mt_pair(setup, {"c0": _tree(jcfg, 30),
                                  "c1": _tree(jcfg, 31)})
    prompt = _prompt(jcfg.vocab_size, 11, 7)
    reqs = ["c0", "c1"]
    kw = dict(batch_size=2, max_new_tokens=12, cache_len=64)
    want = np.asarray(jeng.generate_fixed([JRequest(c, prompt)
                                           for c in reqs],
                                          JServeConfig(**kw)))
    got = peng.generate_fixed([Request(c, prompt) for c in reqs],
                              ServeConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), want)
    cfg_full = pcfg.with_overrides(sliding_window=0)
    full = MultiTenantEngine(Model(cfg_full, device="cpu"), cfg_full, pp,
                             peng.registry)
    other = full.generate_fixed([Request(c, prompt) for c in reqs],
                                ServeConfig(**kw))
    assert not torch.equal(other, got), "the window changed nothing"


def test_sampled_fixed_path_replays_from_the_seed(fp32):
    jcfg = fp32[0]
    _, peng = _mt_pair(fp32, {"c0": _tree(jcfg, 10), "c1": _tree(jcfg, 11)})
    reqs = [Request(c, _prompt(jcfg.vocab_size, 6)) for c in ("c0", "c1")]
    sc = ServeConfig(batch_size=2, max_new_tokens=8, cache_len=16,
                     temperature=0.8, seed=5)
    a = peng.generate_fixed(reqs, sc)
    b = peng.generate_fixed(reqs, sc)
    c = peng.generate_fixed(reqs, ServeConfig(batch_size=2, max_new_tokens=8,
                                              cache_len=16, temperature=0.8,
                                              seed=6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = peng.generate_fixed(reqs, ServeConfig(batch_size=2,
                                                   max_new_tokens=8,
                                                   cache_len=16))
    assert torch.equal(a[:, 0], greedy[:, 0])     # first token is argmax


# ---------------------------------------------------------------------------
# the reference's own properties, inside the port (its default bf16 config)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16():
    return _setup()


def test_mixed_batch_matches_single_tenant_greedy(bf16):
    """``tests/test_multitenant.py``: a two-client interleaved fixed batch
    equals each client's single-tenant ``Engine`` stream."""
    jcfg, pcfg, _, _, pm, pp = bf16
    trees = {"c0": _tree(jcfg, 1, 0.02), "c1": _tree(jcfg, 2, 0.02)}
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for cid, tree in trees.items():
        reg.register(cid, bridge.adapters_from_jax(tree, device="cpu"))
    mt = MultiTenantEngine(pm, pcfg, pp, reg)
    prompt = _prompt(jcfg.vocab_size)
    sc = ServeConfig(batch_size=1, max_new_tokens=8, cache_len=32)
    order = ["c1", "c0", "c1", "c0"]
    out = mt.generate_fixed([Request(c, prompt) for c in order], sc)
    singles = {cid: Engine(pm, pcfg, pp, bridge.adapters_from_jax(
        tree, device="cpu")).generate(prompt[None], sc)[0]
        for cid, tree in trees.items()}
    assert not torch.equal(singles["c0"], singles["c1"]), "clients differ"
    for i, cid in enumerate(order):
        assert torch.equal(out[i], singles[cid]), (i, cid)


def test_unregistered_slot_serves_base_model(bf16):
    """A zeroed bank slot is a no-op adapter: identical to no adapters."""
    jcfg, pcfg, _, _, pm, pp = bf16
    reg = AdapterRegistry(pcfg, capacity=2, device="cpu")
    zero = jax.tree.map(np.zeros_like, _tree(jcfg, 5))
    reg.register("zero", bridge.adapters_from_jax(zero, device="cpu"))
    mt = MultiTenantEngine(pm, pcfg, pp, reg)
    prompt = _prompt(jcfg.vocab_size)
    sc = ServeConfig(batch_size=1, max_new_tokens=6, cache_len=32)
    out = mt.generate_fixed([Request("zero", prompt)], sc)[0]
    base_out = Engine(pm, pcfg, pp, None).generate(prompt[None], sc)[0]
    assert torch.equal(out, base_out)


def test_continuous_equal_shape_bitmatches_fixed(bf16):
    """``tests/test_continuous.py``: equal-length, equal-budget greedy
    requests through the slot engine equal the fixed-batch engine, token
    for token."""
    jcfg, pcfg, _, _, pm, pp = bf16
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for i in range(2):
        reg.register(f"c{i}", bridge.adapters_from_jax(
            _tree(jcfg, 1 + i, 0.02), device="cpu"))
    mt = MultiTenantEngine(pm, pcfg, pp, reg)
    prompt = np.arange(8, dtype=np.int32) % jcfg.vocab_size
    sc = ServeConfig(batch_size=4, max_new_tokens=8, cache_len=32,
                     block_size=8)
    reqs = [Request(c, prompt) for c in ["c1", "c0", "c1", "c0"]]
    fixed = mt.generate_fixed(reqs, sc).numpy()
    cont = mt.generate(reqs, sc)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(cont[i], fixed[i])


def test_eos_engine_pads_after_eos(bf16):
    """``tests/test_continuous.py``: the single-tenant engine with
    ``eos_id`` emits the greedy stream through EOS, then ``pad_id``."""
    jcfg, pcfg, _, _, pm, pp = bf16
    eng = Engine(pm, pcfg, pp, bridge.adapters_from_jax(_tree(jcfg, 1, 0.02),
                                                         device="cpu"))
    prompt = np.arange(8, dtype=np.int32) % jcfg.vocab_size
    base_out = eng.generate(prompt[None], ServeConfig(
        batch_size=1, max_new_tokens=8, cache_len=64))[0].numpy()
    eos = int(base_out[2])
    out = eng.generate(prompt[None], ServeConfig(
        batch_size=1, max_new_tokens=8, cache_len=64, eos_id=eos,
        pad_id=0))[0].numpy()
    cut = np.flatnonzero(base_out == eos)[0]
    np.testing.assert_array_equal(out[:cut + 1], base_out[:cut + 1])
    np.testing.assert_array_equal(out[cut + 1:], 0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_fixed_tenants_demo_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "3", "--batch", "4",
          "--new-tokens", "3", "--no-continuous"])
    out = capsys.readouterr().out
    assert "3 tenants resident, fixed mixed batch of 4 on cpu: 12 tokens" \
        in out
    assert out.count("  client") == 3


def test_serve_cli_single_tenant_dual_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "0", "--dual",
          "--batch", "2", "--new-tokens", "3", "--cache-len", "64"])
    out = capsys.readouterr().out
    assert ("single tenant (Eq. 7-merged pair) on cpu: 6 tokens" in out
            and "cache_len 64" in out)
    with pytest.raises(SystemExit, match="need --tenants"):
        main(["--smoke", "--device", "cpu", "--tenants", "0",
              "--continuous"])
    with pytest.raises(SystemExit, match="cannot combine"):
        main(["--smoke", "--device", "cpu", "--tenants", "2", "--dual"])

"""The rest of the dense family (gemma-2b, olmo-1b, yi-6b, starcoder2-15b)
through the port against the reference package on the CPU.

For each arch: its configs equal the reference's field by field; on the
smoke config (fp32 activations and weights, the reference init bridged,
numpy-seeded adapters with a non-zero B) the forward logits, a ragged
prefill chunk then a decode step through bf16 paged pools (the reference's
jnp paged branch), greedy streams through ``MultiTenantEngine`` and, for
gemma-smoke and starcoder2-smoke, one train step match the reference.
starcoder2-smoke has a sliding window of 16: the prompts and contexts
below run past it, so the window binds (each such test checks that it
does).  The CLI serves each smoke arch on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.lora import tree_leaves
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.training.train_step import lora_value_and_grad

ARCHS = ["gemma-2b", "olmo-1b", "yi-6b", "starcoder2-15b"]
# fp32 on both sides: matmul and softmax summation orders differ, nothing
# else (logits here are O(1))
LOGIT_TOL = 1e-4
# logits that read bf16 pools written in the same step: fp32 order noise
# puts a K/V value on the other side of a bf16 rounding boundary now and
# then (one ulp, 2^-8 of it), and a logit of O(1) that reads it moves by up
# to about that much of its attention term (yi-smoke: 9.4e-4); the bound
# for one bf16 rounding that ``test_torch_model`` also uses
POOL_TOL = 2e-3
# a train step: losses O(6), gradients O(0.1), fp32 summation order only
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    jcfg = j_get_config(arch, smoke=True).with_overrides(
        dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, pcfg, pm, pp


def _adapters(jcfg, seed, clients=None):
    """A numpy-seeded adapter tree with non-zero B: single (leaves (P,
    d_in, r)) or, with ``clients``, a bank (P, C, d_in, r)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)

    def leaf(l):
        shape = l.shape if clients is None else (l.shape[0], clients) + \
            l.shape[1:]
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree.map(leaf, tmpl)


def _window_binds(jcfg, max_pos):
    """starcoder2-smoke's window is shorter than the contexts used here."""
    return jcfg.sliding_window == 0 or max_pos >= jcfg.sliding_window


def test_all_five_dense_archs_are_served():
    # the five dense archs, since the MoE slice the two MoE ones, since
    # the SSM slice mamba2-2.7b and jamba-v0.1-52b, and since the VLM and
    # encoder-decoder slice internvl2-26b and whisper-small
    assert set(ALL_ARCHS) == {"llama2-7b", *ARCHS, "dbrx-132b",
                              "kimi-k2-1t-a32b", "mamba2-2.7b",
                              "jamba-v0.1-52b", "internvl2-26b",
                              "whisper-small"}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch, smoke):
    want = bridge.config_from_jax(j_get_config(arch, smoke=smoke))
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_with_a_banked_adapter_match_reference(arch):
    jcfg, jm, jp, _, pm, pp = _setup(arch)
    ad = _adapters(jcfg, 1, clients=3)
    S = 40                                # past starcoder2-smoke's window
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, S))
    ids = np.asarray([2, 0, 1], np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       jax.tree.map(jnp.asarray, ad), 2.0,
                       adapter_ids=jnp.asarray(ids))
    lp, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)},
                       bridge.adapters_from_jax(ad, device="cpu"), 2.0,
                       adapter_ids=torch.from_numpy(ids))
    assert lp.shape == (3, S, jcfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=LOGIT_TOL)
    assert _window_binds(jcfg, S - 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_the_reference_paged_branch(arch):
    """A ragged prefill chunk behind 12 positions of earlier context (one
    row past its prompt end, one inactive), then a decode step, banked
    adapters: logits at every valid position and the bf16 pools against
    the reference's jnp paged branch.  Row 0 reaches position 32, past
    starcoder2-smoke's window of 16.  After each step the pools agree to
    one bf16 rounding, and the reference's pools are copied into the
    port's, so that a step's rounding flips do not carry into the next."""
    jcfg, jm, jp, _, pm, pp = _setup(arch)
    C, B, T, bs, NB, MB = 3, 3, 20, 4, 40, 10
    bank = _adapters(jcfg, 3, clients=C)
    jbank = jax.tree.map(jnp.asarray, bank)
    pbank = bridge.adapters_from_jax(bank, device="cpu")
    rng = np.random.default_rng(4)
    ids = np.asarray([1, 2, 0], np.int32)
    bt = np.zeros((B, MB), np.int32)
    bt[0] = rng.permutation(np.arange(1, 20))[:MB]
    bt[1] = rng.permutation(np.arange(20, NB))[:MB]
    jc = jm.init_paged_decode_cache(B, NB, bs)
    pc = pm.init_paged_decode_cache(NB, bs)
    common = dict(lora_scale=2.0)

    def both_prefill(jc, pc, toks, lens, n_new):
        lj, jc = jm.prefill_step(jp, jc, jnp.asarray(toks), jnp.asarray(lens),
                                 jnp.asarray(n_new), adapters=jbank,
                                 adapter_ids=jnp.asarray(ids),
                                 block_tables=jnp.asarray(bt),
                                 paged_backend="jnp", **common)
        lp, pc = pm.prefill_step(pp, pc, torch.from_numpy(toks),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(n_new), adapters=pbank,
                                 adapter_ids=torch.from_numpy(ids),
                                 block_tables=torch.from_numpy(bt),
                                 paged_backend="torch", **common)
        return lj, jc, lp, pc

    def check_and_sync_pools():
        for name in ("k_pool", "v_pool"):
            want = np.asarray(jc["blocks"]["b0"][name], np.float32)
            for i, layer in enumerate(pc["layers"]):
                # block 0 is scratch (ragged tails land there in any order)
                np.testing.assert_allclose(layer[name].float().numpy()[1:],
                                           want[i][1:], atol=1e-2,
                                           rtol=2 ** -7)
                layer[name].copy_(torch.from_numpy(want[i]))

    # earlier context of row 0 (positions 0..11), then the ragged chunk
    ctx = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    zero = np.zeros((B,), np.int32)
    _, jc, _, pc = both_prefill(jc, pc, ctx, zero,
                                np.asarray([12, 0, 0], np.int32))
    check_and_sync_pools()
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([12, 0, 0], np.int32)
    n_new = np.asarray([T, 13, 0], np.int32)
    lj, jc, lp, pc = both_prefill(jc, pc, toks, lens, n_new)
    valid = np.arange(T)[None, :] < n_new[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], np.asarray(lj)[valid],
                               atol=POOL_TOL)
    check_and_sync_pools()
    lens2 = lens + n_new
    step = np.asarray([[7], [11], [0]], np.int32)
    lj2, jc = jm.decode_step(jp, jc, jnp.asarray(step), jnp.asarray(lens2),
                             adapters=jbank, adapter_ids=jnp.asarray(ids),
                             block_tables=jnp.asarray(bt),
                             paged_backend="jnp", **common)
    lp2, pc = pm.decode_step(pp, pc, torch.from_numpy(step),
                             torch.from_numpy(lens2), adapters=pbank,
                             adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt),
                             paged_backend="torch", **common)
    np.testing.assert_allclose(lp2.numpy()[:2], np.asarray(lj2)[:2],
                               atol=POOL_TOL)
    assert _window_binds(jcfg, int(lens2[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_the_reference_engine(arch):
    """3 tenants, 6 ragged requests (prompts of 5 to 40 tokens) over 4
    slots with 8-token chunks: the token streams are equal."""
    jcfg, jm, jp, pcfg, pm, pp = _setup(arch)
    jreg = JRegistry(jcfg, capacity=4)
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for i in range(3):
        tree = _adapters(jcfg, 100 + i)
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    jeng = JEngine(jm, jcfg, jp, jreg)
    peng = MultiTenantEngine(pm, pcfg, pp, reg)
    rng = np.random.default_rng(0)
    reqs = [(f"c{i % 3}", rng.integers(0, jcfg.vocab_size,
                                       int(rng.integers(5, 41)))
             .astype(np.int32), int(rng.integers(3, 9))) for i in range(6)]
    kw = dict(batch_size=4, max_new_tokens=8, prefill_chunk=8, block_size=4)
    jout = jeng.generate([JRequest(c, p, max_new_tokens=b)
                          for c, p, b in reqs],
                         JServeConfig(overlap=False, **kw))
    pout = peng.generate([Request(c, p, max_new_tokens=b)
                          for c, p, b in reqs], ServeConfig(**kw))
    assert [list(map(int, o)) for o in pout] == \
        [list(map(int, o)) for o in jout]
    assert _window_binds(jcfg, max(len(p) for _, p, _ in reqs))


@pytest.mark.parametrize("arch", ["gemma-2b", "starcoder2-15b"])
def test_train_step_loss_and_gradients_match_reference(arch):
    """One LoRA train step (48 positions: past starcoder2-smoke's window):
    the loss and every adapter gradient against ``jax.value_and_grad``."""
    jcfg, jm, jp, pcfg, pm, pp = _setup(arch)
    ad = _adapters(jcfg, 1)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (3, 48))
             .astype(np.int32),
             "loss_mask": (rng.random((3, 48)) < 0.7).astype(np.int32)}
    loss_fn = j_ts.make_lora_loss_fn(jm, jcfg)
    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, ad), jp, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = lora_value_and_grad(pm, pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    got = dict(tree_leaves(grads))
    want = dict(tree_leaves(bridge.adapters_from_jax(
        jax.tree.map(np.asarray, jg), device="cpu")))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)
    assert _window_binds(jcfg, 47)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_smoke_arch_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--tenants", "2",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "2 tenants, 4 ragged requests over 2 slots on cpu" in out
    streams = [ln for ln in out.splitlines() if ln.startswith("  client")]
    assert streams and all("[" in ln and "]" in ln for ln in streams)

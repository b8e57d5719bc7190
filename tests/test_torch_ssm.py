"""The SSM and hybrid families (mamba2-2.7b, jamba-v0.1-52b) through the
port against the reference package on the CPU.

The configs field by field (full and smoke) and their parameter counts;
``models/mamba2.py`` alone: ``ssd_chunked`` over several chunks, and
``apply_mamba``'s three branches (the SSD chunked form, the one-token
recurrence, the chunked recurrence over a ragged chunk with a row at
``n_new`` 0); the chunked recurrence bitwise equal to one-token steps;
forward logits on ``tiny_ssm``, the hybrid of ``tests/test_models.py``,
mamba2-smoke and jamba-smoke; LoRA zero-init; the fixed path's decode
steps against the forward and the reference; a ragged paged prefill
chunk then a decode step, logits and states; greedy engine streams
(overlap on and off, slots reused, one slot serving requests in turn, a
ragged bank over int8 K/V on jamba, 2 shards), the fixed path's streams
against continuous batching;
the refusals of prefix caching and speculative decoding; a train step on
both smoke configs; the serve CLI per arch.  Weights come from the
reference init, bridged; adapters are numpy-seeded with a non-zero B;
activations fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_ssm
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models import mamba2 as j_mamba2
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.lora import init_adapters, tree_leaves
from repro_torch.models import mamba2
from repro_torch.models.api import Model
from repro_torch.serving.engine import (Engine, MultiTenantEngine, Request,
                                        ServeConfig)
from repro_torch.serving.kv_cache import reset_slot
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.sharded import ShardedAdapterRegistry
from repro_torch.training.train_step import lora_value_and_grad

ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]
# the tolerances of tests/test_torch_dense_family.py: fp32 summation order
# on O(1) logits (the SSD scan and the recurrence add exp and matmul order
# noise of the same size); one bf16 rounding of a pool value read back; a
# train step
LOGIT_TOL = 1e-4
POOL_TOL = 2e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# mamba2 alone in fp32: outputs and states O(1)
SSM_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def tiny_hybrid(**kw):
    """The hybrid of ``tests/test_models.py``."""
    return tiny_dense(
        name="hy", family="hybrid",
        layer_pattern=("mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe"),
        n_layers=4, n_experts=4, n_experts_per_tok=2, ssm_d_state=16,
        ssm_head_dim=16, ssm_chunk=8, **kw)


CASES = {"tiny_ssm": lambda: tiny_ssm(),
         "tiny_hybrid": lambda: tiny_hybrid(),
         "mamba2-smoke": lambda: j_get_config("mamba2-2.7b", smoke=True),
         "jamba-smoke": lambda: j_get_config("jamba-v0.1-52b", smoke=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's SSM and MoE paths run thousands of small torch ops (the
    recurrence steps one token at a time); with the suite's worker
    processes sharing the cores, each op's thread team waits for
    descheduled threads (one jamba-smoke engine test took 217 s instead of
    1.5 s).  One intra-op thread for this file, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    """name -> (jcfg, jax model, jax params, port cfg, port model, port
    params), fp32 activations and weights, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = CASES[name]().with_overrides(
                dtype="float32", param_dtype="float32", remat=False)
            jm = get_model(jcfg)
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
            pcfg = bridge.config_from_jax(jcfg)
            cache[name] = (jcfg, jm, jp, pcfg, Model(pcfg, device="cpu"),
                           bridge.params_from_jax(_np(jp), device="cpu"))
        return cache[name]
    return get


def _adapters(jcfg, seed, clients=None, rank=None):
    """A numpy-seeded adapter tree with non-zero B in the reference layout:
    single (leaves (P, d_in, r)) or, with ``clients``, a bank (P, C, d_in,
    r)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank)
    rng = np.random.default_rng(seed)

    def leaf(l):
        shape = l.shape if clients is None else (l.shape[0], clients) + \
            l.shape[1:]
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree.map(leaf, tmpl)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch, smoke):
    jcfg = j_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        bridge.config_from_jax(jcfg))
    assert (got.ssm_d_inner, got.ssm_n_heads) == (jcfg.ssm_d_inner,
                                                  jcfg.ssm_n_heads)
    for mixer in ("attn", "mamba"):
        assert got.has_mixer(mixer) == jcfg.has_mixer(mixer)
    assert arch in ALL_ARCHS


@pytest.mark.parametrize("arch,want", [("mamba2-2.7b", 2_830_780_416),
                                       ("jamba-v0.1-52b", 51_459_533_312)])
def test_parameter_counts_equal_the_reference(arch, want):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert cfg.count_params() == jcfg.count_params() == want
    assert cfg.count_active_params() == jcfg.count_active_params()


def test_hybrid_patterns_are_checked_entry_by_entry():
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    assert cfg.with_overrides(layer_pattern=("attn+moe", "mamba+none"),
                              n_layers=2).layer_entry(1) == "mamba+none"
    with pytest.raises(NotImplementedError):
        cfg.with_overrides(layer_pattern=("mamba+mlp", "conv+mlp"),
                           n_layers=2)
    with pytest.raises(NotImplementedError):
        get_config("mamba2-2.7b").with_overrides(
            layer_pattern=("mamba+mlp",))
    with pytest.raises(ValueError):
        cfg.with_overrides(n_layers=6)


# ---------------------------------------------------------------------------
# models/mamba2.py alone
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B, S, H, P, G, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (rng.random((B, S, H)) * 0.5 + 0.01).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_over_several_chunks_matches_reference(G):
    """4 chunks of 8 (and H over G groups): outputs and final state."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(G), 2, 32, 4, 8,
                                   G, 16)
    jy, jh = jax.jit(j_mamba2.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), 8)
    py, ph = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                8)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=SSM_TOL,
                               rtol=SSM_TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=SSM_TOL,
                               rtol=SSM_TOL)


def test_ssd_chunked_backward_is_finite_and_refuses_a_ragged_chunk():
    """The causal mask comes before the exp, so the backward through the
    masked (s > t) terms is 0, not 0·inf; S must be a multiple of the
    chunk, as the reference asserts."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(
        np.random.default_rng(5), 1, 16, 2, 4, 1, 8))
    dt = (dt * 40).requires_grad_(True)        # large decays: exp overflow
    x.requires_grad_(True)
    y, h = mamba2.ssd_chunked(x, dt, A, Bm, Cm, 8)
    gx, gdt = torch.autograd.grad((y.sum() + h.sum()), (x, dt))
    assert bool(torch.isfinite(gx).all() and torch.isfinite(gdt).all())
    with pytest.raises(AssertionError):
        mamba2.ssd_chunked(x, dt, A, Bm, Cm, 5)


def _mamba_layer(setups, name="mamba2-smoke"):
    """(jcfg, pcfg, reference layer params, port layer params, a bank of
    3 clients on the layer's projections in both layouts)."""
    jcfg, _, jp, pcfg, _, pp = setups(name)
    jl = jax.tree.map(lambda l: l[0], jp["blocks"]["b0"]["mixer"])
    bank = jax.tree.map(lambda l: l[0], _adapters(jcfg, 9, clients=3)
                        ["blocks"]["b0"]["mixer"])
    pbank = {t: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
             for t, ab in bank.items()}
    return (jcfg, pcfg, jl, pp["layers"][0]["mixer"],
            jax.tree.map(jnp.asarray, bank), pbank)


def _state(cfg, B, rng):
    """A random decode state in the reference layout (conv in bf16, as
    ``init_ssm_cache`` makes it)."""
    c = j_mamba2.init_ssm_cache(cfg, B)
    return {"h": rng.standard_normal(c["h"].shape).astype(np.float32),
            "conv": np.asarray(jnp.asarray(
                rng.standard_normal(c["conv"].shape), jnp.bfloat16))}


@pytest.mark.parametrize("branch", ["ssd", "one_token", "ragged_chunk"])
def test_apply_mamba_branches_match_reference(setups, branch):
    """One banked mamba layer: the SSD chunked form (no cache, S 16 over
    chunks of 8), the one-token recurrence, and a ragged chunk of 7 whose
    rows hold 7, 3 and 0 valid tokens: outputs at valid positions and the
    new states equal the reference's; the row at 0 keeps its state."""
    jcfg, pcfg, jl, pl, jbank, pbank = _mamba_layer(setups)
    rng = np.random.default_rng(3)
    B, S = 3, {"ssd": 16, "one_token": 1, "ragged_chunk": 7}[branch]
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ids = np.asarray([2, 0, 1], np.int32)
    state = None if branch == "ssd" else _state(jcfg, B, rng)
    n_new = (np.asarray([7, 3, 0], np.int32) if branch == "ragged_chunk"
             else None)
    jout, jc = jax.jit(lambda p, x, a, c, i, n: j_mamba2.apply_mamba(
        p, x, jcfg, a, 2.0, ssm_cache=c, adapter_ids=i, n_new=n))(
        jl, jnp.asarray(x), jbank,
        None if state is None else jax.tree.map(jnp.asarray, state),
        jnp.asarray(ids), None if n_new is None else jnp.asarray(n_new))
    pout, pc = mamba2.apply_mamba(
        pl, torch.from_numpy(x), pcfg, pbank, 2.0,
        ssm_cache=None if state is None else bridge._map(
            lambda l: bridge.to_torch(l, "cpu"), state),
        adapter_ids=torch.from_numpy(ids),
        n_new=None if n_new is None else torch.from_numpy(n_new))
    valid = (np.ones((B, S), bool) if n_new is None
             else np.arange(S)[None, :] < n_new[:, None])
    np.testing.assert_allclose(pout.numpy()[valid], np.asarray(jout)[valid],
                               atol=SSM_TOL, rtol=SSM_TOL)
    assert pc["h"].dtype == torch.float32
    assert pc["conv"].dtype == torch.float32      # the activations' dtype
    for k in ("h", "conv"):
        np.testing.assert_allclose(pc[k].float().numpy(),
                                   np.asarray(jc[k], np.float32),
                                   atol=SSM_TOL, rtol=SSM_TOL, err_msg=k)
    if n_new is not None:
        assert torch.equal(pc["h"][2], torch.from_numpy(state["h"][2]))
        assert torch.equal(pc["conv"][2],
                           bridge.to_torch(state["conv"][2], "cpu").float())


def test_chunked_recurrence_equals_one_token_steps_bitwise():
    """The recurrence over a chunk of 13 tokens, some masked (dt 0), and
    13 one-token calls from the same state: outputs and state equal bit
    for bit."""
    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(rng, 3, 13, 8, 16, 2, 16))
    dt[1, 5:] = 0.0
    dt[2] = 0.0
    h0 = torch.from_numpy(rng.standard_normal((3, 8, 16, 16))
                          .astype(np.float32))
    y, h = mamba2.ssm_recurrence(h0, x, dt, A, Bm, Cm)
    hs, ys = h0, []
    for t in range(13):
        yt, hs = mamba2.ssm_recurrence(hs, x[:, t:t + 1], dt[:, t:t + 1], A,
                                       Bm[:, t:t + 1], Cm[:, t:t + 1])
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(hs, h)
    assert torch.equal(h[2], h0[2])              # a row fed only padding


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_with_a_banked_adapter_match_reference(setups, name):
    jcfg, jm, jp, _, pm, pp = setups(name)
    ad = _adapters(jcfg, 1, clients=3)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 24))
    ids = np.asarray([2, 0, 1], np.int32)
    lj, aj = jax.jit(lambda p, t, a, i: jm.forward(
        p, {"tokens": t}, a, 2.0, adapter_ids=i))(
        jp, jnp.asarray(toks, jnp.int32), jax.tree.map(jnp.asarray, ad),
        jnp.asarray(ids))
    lp, ap = pm.forward(pp, {"tokens": torch.from_numpy(toks)},
                        bridge.adapters_from_jax(ad, device="cpu"), 2.0,
                        adapter_ids=torch.from_numpy(ids))
    assert lp.shape == (3, 24, jcfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=LOGIT_TOL)
    assert abs(float(ap) - float(aj)) <= 1e-5


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_adapter_shapes_follow_the_reference(setups, name):
    """Mamba layers carry ``in_proj``/``out_proj`` pairs whatever
    ``lora_targets`` says (jamba's names only attention and MLP weights),
    as in the reference."""
    jcfg, *_, pcfg, _, _ = setups(name)
    want = {p: tuple(t.shape) for p, t in tree_leaves(
        bridge.adapters_from_jax(_np(j_init_adapters(
            jax.random.PRNGKey(0), jcfg)), device="cpu"))}
    got = {p: tuple(t.shape) for p, t in tree_leaves(
        init_adapters(pcfg, device="cpu"))}
    assert got == want
    assert "in_proj" not in pcfg.lora_targets or name == "mamba2-smoke"
    assert any("in_proj" in p for p in got)


@pytest.mark.parametrize("name", ["tiny_ssm", "tiny_hybrid"])
def test_lora_zero_init_is_the_base_model(setups, name):
    _, _, _, pcfg, pm, pp = setups(name)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (2, 16)))}
    base, _ = pm.forward(pp, toks)
    with_lora, _ = pm.forward(pp, toks, init_adapters(pcfg, device="cpu"),
                              2.0)
    np.testing.assert_allclose(with_lora.numpy(), base.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["tiny_ssm", "tiny_hybrid"])
def test_fixed_path_decode_equals_forward_and_the_reference(setups, name):
    """Sequential decode steps through ``init_decode_cache`` (bf16 ring
    buffers and per-row SSM state): logits at every position equal the
    reference's decode steps' and the forward's (which reads K/V
    unrounded: one bf16 rounding apart)."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    ad = _adapters(jcfg, 3)
    jad = jax.tree.map(jnp.asarray, ad)
    pad = bridge.adapters_from_jax(ad, device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 16))
    full, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)}, pad, 2.0)
    jc, pc = jm.init_decode_cache(2, 32), pm.init_decode_cache(2, 32)
    step = jax.jit(lambda p, c, t, n, a: jm.decode_step(
        p, c, t, n, adapters=a, lora_scale=2.0))
    for t in range(toks.shape[1]):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t), jad)
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(toks[:, t:t + 1]),
                                t, adapters=pad, lora_scale=2.0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, t].numpy(),
                                   atol=POOL_TOL)


def test_paged_cache_needs_num_slots_and_holds_per_slot_state(setups):
    _, _, _, pcfg, pm, _ = setups("jamba-smoke")
    with pytest.raises(ValueError, match="num_slots"):
        pm.init_paged_decode_cache(8, 4)
    cache = pm.init_paged_decode_cache(8, 4, num_slots=3)
    kinds = [sorted(c) for c in cache["layers"]]
    assert kinds == [["conv", "h"], ["conv", "h"], ["k_pool", "v_pool"],
                     ["conv", "h"]]
    h, conv = cache["layers"][0]["h"], cache["layers"][0]["conv"]
    assert h.shape == (3, pcfg.ssm_n_heads, pcfg.ssm_head_dim,
                       pcfg.ssm_d_state) and h.dtype == torch.float32
    assert conv.shape == (3, pcfg.ssm_d_conv - 1,
                          pcfg.ssm_d_inner + 2 * pcfg.ssm_d_state)
    assert conv.dtype == torch.bfloat16
    state = sum(t.numel() * t.element_size() for c in cache["layers"]
                for k, t in c.items() if k in ("h", "conv"))
    per_layer = (pcfg.ssm_n_heads * pcfg.ssm_head_dim * pcfg.ssm_d_state * 4
                 + (pcfg.ssm_d_conv - 1) * conv.shape[2] * 2)
    assert state == 3 * 3 * per_layer            # 3 slots, 3 mamba layers
    # reset_slot zeroes one slot's rows of every mamba layer, whatever
    # dtype the conv state has taken (fp32 after an fp32 step)
    for c in cache["layers"]:
        for k in ("h", "conv"):
            if k in c:
                c[k] = torch.ones_like(c[k], dtype=torch.float32)
    reset_slot(cache, 1)
    for c in cache["layers"]:
        if "h" in c:
            for k in ("h", "conv"):
                assert float(c[k][1].abs().max()) == 0
                assert float(c[k][0].min()) == float(c[k][2].min()) == 1


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_prefill_then_decode_match_the_reference_paged_cache(setups, name):
    """One ragged chunk (rows of 9, 4 and 0 valid tokens over 9) from
    random SSM states, then a decode step: logits at valid positions, the
    SSM states and the pools against the reference's jnp paged branch
    (its caches bridged with ``bridge.adapters_from_jax``; states after an
    attention layer within the pools' bf16 bound); the row fed nothing
    keeps its state."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    C, B, T, bs, NB, MB = 3, 3, 9, 4, 16, 4
    bank = _adapters(jcfg, 3, clients=C)
    jbank = jax.tree.map(jnp.asarray, bank)
    pbank = bridge.adapters_from_jax(bank, device="cpu")
    rng = np.random.default_rng(4)
    ids = np.asarray([1, 2, 0], np.int32)
    bt = (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB)
    jc = jm.init_paged_decode_cache(B, NB, bs)
    for name_, entry in jc["blocks"].items():    # random SSM states
        if "h" in entry:
            jc["blocks"][name_] = {
                "h": jnp.asarray(rng.standard_normal(entry["h"].shape),
                                 jnp.float32),
                "conv": jnp.asarray(rng.standard_normal(
                    entry["conv"].shape), jnp.bfloat16)}
    pc = bridge.adapters_from_jax(_np(jc), device="cpu")
    before = [{k: v.clone() for k, v in c.items()} for c in pc["layers"]]
    toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([3, 0, 5], np.int32)
    n_new = np.asarray([9, 4, 0], np.int32)
    toks[np.arange(T)[None, :] >= n_new[:, None]] = 0     # padded tails
    lj, jc = jax.jit(lambda p, c, t, n, k, a, i, b: jm.prefill_step(
        p, c, t, n, k, adapters=a, lora_scale=2.0, adapter_ids=i,
        block_tables=b, paged_backend="jnp"))(
        jp, jc, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(n_new),
        jbank, jnp.asarray(ids), jnp.asarray(bt))
    lp, pc = pm.prefill_step(pp, pc, torch.from_numpy(toks),
                             torch.from_numpy(lens), torch.from_numpy(n_new),
                             adapters=pbank, lora_scale=2.0,
                             adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt),
                             paged_backend="torch")
    valid = np.arange(T)[None, :] < n_new[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], np.asarray(lj)[valid],
                               atol=POOL_TOL)
    want = bridge.adapters_from_jax(_np(jc), device="cpu")
    tol = SSM_TOL           # until an attention layer reads bf16 pools
    for i, (got, ref, old) in enumerate(zip(pc["layers"], want["layers"],
                                            before)):
        if "h" in got:
            for k in ("h", "conv"):
                np.testing.assert_allclose(
                    got[k].float().numpy(), ref[k].float().numpy(),
                    atol=tol, rtol=tol, err_msg=f"layer {i} {k}")
                assert torch.equal(got[k][2].float(), old[k][2].float())
        else:
            for k in ("k_pool", "v_pool"):
                np.testing.assert_allclose(
                    got[k].float().numpy()[1:], ref[k].float().numpy()[1:],
                    atol=1e-2, rtol=2 ** -7)
                got[k].copy_(ref[k])
            tol = POOL_TOL
    lens2 = lens + n_new
    step = np.asarray([[7], [11], [5]], np.int32)
    lj2, _ = jax.jit(lambda p, c, t, n, a, i, b: jm.decode_step(
        p, c, t, n, adapters=a, lora_scale=2.0, adapter_ids=i,
        block_tables=b, paged_backend="jnp"))(
        jp, jc, jnp.asarray(step), jnp.asarray(lens2), jbank,
        jnp.asarray(ids), jnp.asarray(bt))
    lp2, _ = pm.decode_step(pp, pc, torch.from_numpy(step),
                            torch.from_numpy(lens2), adapters=pbank,
                            lora_scale=2.0, adapter_ids=torch.from_numpy(ids),
                            block_tables=torch.from_numpy(bt),
                            paged_backend="torch")
    np.testing.assert_allclose(lp2.numpy(), np.asarray(lj2), atol=POOL_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _registries(setups, name, ranks=None, shards=None):
    """A reference and a port registry with clients c0..c2 registered (at
    ``ranks[i % len]`` with ``ranks``; sharded with ``shards``)."""
    jcfg, _, _, pcfg, _, _ = setups(name)
    kw = dict(ranks=ranks) if ranks else {}
    jreg = JRegistry(jcfg, capacity=4, **kw)
    reg = (ShardedAdapterRegistry(pcfg, capacity=4, num_shards=shards,
                                  device="cpu", **kw) if shards
           else AdapterRegistry(pcfg, capacity=4, device="cpu", **kw))
    for i in range(3):
        rank = ranks[i % len(ranks)] if ranks else None
        tree = _adapters(jcfg, 100 + i, rank=rank)
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    return jreg, reg


def _requests(jcfg, n=6):
    rng = np.random.default_rng(0)
    return [(f"c{i % 3}", rng.integers(0, jcfg.vocab_size,
                                       int(rng.integers(5, 41)))
             .astype(np.int32), int(rng.integers(3, 9))) for i in range(n)]


SC = dict(batch_size=4, max_new_tokens=8, prefill_chunk=8, block_size=4)
_JAX_STREAMS = {}


def _jax_streams(setups, name, ranks=None, batch_size=4, **extra):
    """The reference engine's streams of ``_requests``, computed once per
    (config, ranks, slots, options)."""
    key = (name, tuple(ranks or ()), batch_size, tuple(sorted(extra.items())))
    if key not in _JAX_STREAMS:
        jcfg, jm, jp = setups(name)[:3]
        jreg, _ = _registries(setups, name, ranks)
        out = JEngine(jm, jcfg, jp, jreg).generate(
            [JRequest(c, p, max_new_tokens=b) for c, p, b in
             _requests(jcfg)],
            JServeConfig(overlap=False, **dict(SC, batch_size=batch_size,
                                               **extra)))
        _JAX_STREAMS[key] = [list(map(int, o)) for o in out]
    return _JAX_STREAMS[key]


def _port_streams(setups, name, ranks=None, batch_size=4, shards=None,
                  **kw):
    jcfg, _, _, pcfg, pm, pp = setups(name)
    _, reg = _registries(setups, name, ranks, shards)
    eng = MultiTenantEngine(pm, pcfg, pp, reg)
    out = eng.generate([Request(c, p, max_new_tokens=b)
                        for c, p, b in _requests(jcfg)],
                       ServeConfig(**dict(SC, batch_size=batch_size, **kw)))
    return [list(map(int, o)) for o in out], eng


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_greedy_streams_equal_the_reference_engine(setups, name, overlap,
                                                   monkeypatch):
    """3 tenants, 6 ragged requests (prompts of 5 to 40 tokens) over 4
    slots with 8-token chunks, so two slots are reused: the token streams
    are equal, and each reused slot's state reads zero when its new
    request's first chunk runs."""
    from repro_torch.serving import engine as eng_mod
    resets = []

    def recording_reset(cache, slot):
        out = reset_slot(cache, slot)
        resets.append((slot, all(float(c[k][slot].abs().max()) == 0
                                 for c in out["layers"] for k in ("h", "conv")
                                 if k in c)))
        return out
    monkeypatch.setattr(eng_mod, "reset_slot", recording_reset)
    got, eng = _port_streams(setups, name, overlap=overlap)
    assert got == _jax_streams(setups, name)
    assert len(resets) == 6 and all(zeroed for _, zeroed in resets)
    assert len({slot for slot, _ in resets}) == 4      # two slots reused


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_one_slot_serving_requests_in_turn_equals_fresh_slots(setups, name):
    """One slot serves the 6 requests in turn, its state reset at each
    admission (as ``tests/test_continuous.py`` holds the reference): each
    stream equals the same request served alone in a fresh engine slot;
    on mamba2-smoke, whose rows do not share MoE capacity, also the
    reference engine's stream of it at 4 slots."""
    jcfg, _, _, pcfg, pm, pp = setups(name)
    got, _ = _port_streams(setups, name, batch_size=1)
    if name == "mamba2-smoke":
        assert got == _jax_streams(setups, name)
    _, reg = _registries(setups, name)
    eng = MultiTenantEngine(pm, pcfg, pp, reg)
    for (c, p, b), stream in zip(_requests(jcfg), got):
        alone = eng.generate([Request(c, p, max_new_tokens=b)],
                             ServeConfig(**dict(SC, batch_size=1)))
        assert list(map(int, alone[0])) == stream


def test_jamba_streams_over_a_ragged_bank_with_int8_kv_equal_the_reference(
        setups):
    """Clients at ranks 2 and 4 in a ragged bank (the mamba projections,
    attention, the MLPs and the routers each through the client's bucket
    at its own rank) over int8 K/V pools: the streams equal the reference
    engine's, int8 against its int8."""
    got, _ = _port_streams(setups, "jamba-smoke", ranks=[2, 4],
                           kv_dtype="int8")
    assert got == _jax_streams(setups, "jamba-smoke", ranks=[2, 4],
                               kv_dtype="int8")


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_two_shards_equal_one_pool_and_the_reference(setups, name):
    """The slots split over 2 shards, SSM rows indexed by global slot:
    streams equal the single pool's and the reference engine's."""
    one, _ = _port_streams(setups, name)
    two, eng = _port_streams(setups, name, shards=2, num_shards=2)
    assert eng.last_stats["num_shards"] == 2
    assert two == one == _jax_streams(setups, name)


@pytest.mark.parametrize("feature", ["prefix_cache", "spec_decode"])
def test_recurrent_models_refuse_prefix_cache_and_spec_decode(setups,
                                                              feature):
    jcfg, _, _, pcfg, pm, pp = setups("mamba2-smoke")
    _, reg = _registries(setups, "mamba2-smoke")
    eng = MultiTenantEngine(pm, pcfg, pp, reg)
    with pytest.raises(ValueError, match="attention-only"):
        eng.generate([Request("c0", np.arange(5, dtype=np.int32))],
                     ServeConfig(batch_size=1, max_new_tokens=2,
                                 block_size=4, **{feature: True}))


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_fixed_path_streams_equal_continuous_batching(setups, name):
    """``generate_fixed`` (a mixed-client batch of one prompt) and the
    single-tenant ``Engine``, over ``init_decode_cache``'s SSM state,
    emit the streams continuous batching emits for the same requests (as
    ``tests/test_continuous.py`` holds the reference).  The reference's
    own fixed path cannot run an SSM model at fp32 activations (its
    prefill scan's carry changes dtype with the conv state), so the fixed
    path meets it through its decode steps' logits (above) and here
    through the continuous engine.  MoE capacity 2.0 drops no copy, so
    jamba's rows do not depend on the batch's make-up."""
    jcfg, _, _, pcfg, pm, pp = setups(name)
    pcfg = pcfg.with_overrides(moe_capacity_factor=2.0)
    _, reg = _registries(setups, name)
    eng = MultiTenantEngine(pm, pcfg, pp, reg)
    prompt = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, 12).astype(np.int32)
    reqs = [Request(c, prompt) for c in ("c1", "c0", "c2")]
    kw = dict(batch_size=3, max_new_tokens=6, cache_len=32, block_size=4,
              prefill_chunk=8)
    want = eng.generate(reqs, ServeConfig(**kw))
    got = eng.generate_fixed(reqs, ServeConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    tree = bridge.adapters_from_jax(_adapters(jcfg, 100), device="cpu")
    one = AdapterRegistry(pcfg, capacity=1, device="cpu")
    one.register("c0", tree)
    prompts = [prompt, prompt[::-1].copy()]
    want1 = MultiTenantEngine(pm, pcfg, pp, one).generate(
        [Request("c0", p) for p in prompts], ServeConfig(**kw))
    got1 = Engine(pm, pcfg, pp, tree).generate(np.stack(prompts),
                                              ServeConfig(**kw))
    np.testing.assert_array_equal(got1.numpy(), np.stack(want1))


@pytest.mark.parametrize("name", ["mamba2-smoke", "jamba-smoke"])
def test_train_step_loss_and_gradients_match_reference(setups, name):
    """One LoRA train step through the SSD chunked form (S 32 over chunks
    of 8): the loss (plus jamba's aux loss) and every adapter gradient,
    the mamba projections' included, against ``jax.value_and_grad``."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    ad = _adapters(jcfg, 1)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 32))
             .astype(np.int32),
             "loss_mask": (rng.random((2, 32)) < 0.7).astype(np.int32)}
    loss_fn = j_ts.make_lora_loss_fn(jm, jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, ad), jp, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = lora_value_and_grad(pm, pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    got = dict(tree_leaves(grads))
    want = dict(tree_leaves(bridge.adapters_from_jax(_np(jg), device="cpu")))
    assert got.keys() == want.keys()
    assert any("in_proj" in p for p in got)
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--tenants", "2",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "2 tenants, 4 ragged requests over 2 slots on cpu" in out
    streams = [ln for ln in out.splitlines() if ln.startswith("  client")]
    assert streams and all("[" in ln and "]" in ln for ln in streams)

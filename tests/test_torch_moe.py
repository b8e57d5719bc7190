"""The MoE family (dbrx-132b, kimi-k2-1t-a32b) through the port against
the reference package on the CPU.

``apply_moe`` alone (fp32: output, aux loss, expert ids and the keep mask,
at capacity factors 1.25 and 0.25 where copies drop, for swiglu, geglu
and gelu, without a router adapter, with a banked one and with a ragged
bank); the configs field by field and their parameter counts; forward
logits and aux on ``tiny_moe`` (also tied, where the reference does not
scale the embeddings) and on both smoke configs; a ragged prefill chunk in
which the padded tails fill the experts' capacity ahead of later rows'
real tokens, then a decode step, through bf16 pools; greedy engine streams
(overlap on and off, a ragged bank too); a dbrx-smoke train step with the
aux loss; the serve CLI per MoE arch; every arch of the reference registry
resolving in the port.
Weights come from the reference init, bridged; adapters are numpy-seeded
with a non-zero B.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs.registry import ALL_ARCHS as J_ALL_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models import moe as j_moe
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.serving.sharded import ShardedAdapterRegistry
from repro_torch.training.train_step import lora_value_and_grad

MOE_ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
# the tolerances of tests/test_torch_dense_family.py: fp32 order noise on
# O(1) logits; one bf16 rounding of a pool value read back; a train step
LOGIT_TOL = 1e-4
POOL_TOL = 2e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# apply_moe alone in fp32: outputs O(1), the aux loss O(1)
MOE_TOL = 1e-5
AUX_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# apply_moe alone
# ---------------------------------------------------------------------------

def _record(monkeypatch, module, into):
    """Record every ``_top_k_routing`` result of ``module`` (ids as
    numpy) into ``into``."""
    orig = module._top_k_routing

    def wrapped(logits, k):
        out = orig(logits, k)
        into.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(module, "_top_k_routing", wrapped)


def _keep_from_ids(ids, E, cap):
    """The keep mask by its definition, independent of both dispatches: a
    copy fits when fewer than ``cap`` earlier copies in flat order chose
    its expert."""
    flat = ids.reshape(-1)
    seen = np.zeros(E, np.int64)
    keep = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep


def _router_bank(jcfg, rng, adapter):
    """The router's adapter in the reference layout: None, a bank of 3
    clients at rank 4, or a ragged bank (buckets of 2 clients at rank 2
    and 1 at rank 4, as per-bucket lists)."""
    d, E = jcfg.d_model, jcfg.n_experts

    def pair(c, r):
        return ((rng.standard_normal((c, d, r)) * 0.3).astype(np.float32),
                (rng.standard_normal((c, r, E)) * 0.3).astype(np.float32))
    if adapter is None:
        return None
    if adapter == "bank":
        a, b = pair(3, 4)
        return {"router": {"a": a, "b": b}}
    (a0, b0), (a1, b1) = pair(2, 2), pair(1, 4)
    return {"router": {"a": [a0, a1], "b": [b0, b1]}}


@pytest.mark.parametrize("adapter", [None, "bank", "ragged"])
@pytest.mark.parametrize("factor", [1.25, 0.25])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_apply_moe_matches_reference(mlp_type, factor, adapter,
                                     monkeypatch):
    jcfg = tiny_moe(dtype="float32", param_dtype="float32",
                    mlp_type=mlp_type, moe_capacity_factor=factor)
    pcfg = bridge.config_from_jax(jcfg)
    jp = j_moe.init_moe(jax.random.PRNGKey(3), jcfg.d_model,
                        jcfg.resolved_d_ff_moe, jcfg.n_experts, mlp_type,
                        jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(7)
    B, S = 3, 64
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ad = _router_bank(jcfg, rng, adapter)
    ids = np.asarray([2, 0, 1], np.int32) if adapter else None
    j_ids, p_ids = [], []
    _record(monkeypatch, j_moe, j_ids)
    _record(monkeypatch, moe, p_ids)
    jout, jaux = j_moe.apply_moe(
        jp, jnp.asarray(x), jcfg,
        None if ad is None else jax.tree.map(jnp.asarray, ad), 2.0,
        adapter_ids=None if ids is None else jnp.asarray(ids))
    pad = None if ad is None else {"router": {
        k: ([torch.from_numpy(t) for t in v] if isinstance(v, list)
            else torch.from_numpy(v)) for k, v in ad["router"].items()}}
    kept = []
    orig_dispatch = moe.dispatch
    monkeypatch.setattr(moe, "dispatch", lambda *a: kept.append(
        orig_dispatch(*a)) or kept[-1])
    pout, paux = moe.apply_moe(pp, torch.from_numpy(x), pcfg, pad, 2.0,
                               None if ids is None else torch.from_numpy(ids))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=MOE_TOL)
    assert abs(float(paux) - float(jaux)) <= AUX_TOL
    np.testing.assert_array_equal(p_ids[0], j_ids[0])
    E, k = jcfg.n_experts, jcfg.n_experts_per_tok
    cap = moe.capacity(B * S, k, E, factor)
    want_keep = _keep_from_ids(j_ids[0], E, cap)
    np.testing.assert_array_equal(kept[0][1].numpy(), want_keep)
    if factor < 1:
        assert not want_keep.all(), "capacity did not bind"


def test_top_k_breaks_ties_to_the_lower_expert_like_the_reference():
    logits = np.asarray([[0.0, 1.0, 1.0, 1.0], [2.0, 2.0, 0.0, 2.0],
                         [0.5, 0.5, 0.5, 0.5]], np.float32)
    jw, jids, jaux = j_moe._top_k_routing(jnp.asarray(logits), 2)
    pw, pids, paux = moe._top_k_routing(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-7)
    assert abs(float(paux) - float(jaux)) <= AUX_TOL


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_equals_reference_field_by_field(arch, smoke):
    want = bridge.config_from_jax(j_get_config(arch, smoke=smoke))
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.has_moe() and got.resolved_d_ff_moe == \
        j_get_config(arch, smoke=smoke).resolved_d_ff_moe


@pytest.mark.parametrize("arch", ["llama2-7b", "gemma-2b", "olmo-1b",
                                  "yi-6b", "starcoder2-15b", *MOE_ARCHS])
def test_parameter_counts_equal_the_reference(arch):
    want, got = j_get_config(arch), get_config(arch)
    assert got.count_params() == want.count_params()
    assert got.count_active_params() == want.count_active_params()


@pytest.mark.parametrize("arch", J_ALL_ARCHS)
def test_every_reference_arch_resolves_in_the_port(arch):
    """Every family of the reference registry resolves: the port's config
    equals the reference's field by field."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        bridge.config_from_jax(j_get_config(arch)))


def test_moe_family_with_a_dense_pattern_is_refused():
    with pytest.raises(NotImplementedError):
        get_config("dbrx-132b").with_overrides(layer_pattern=("attn+mlp",))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CASES = {"tiny_moe": lambda: tiny_moe(),
         "tiny_moe_tied": lambda: tiny_moe(tie_embeddings=True),
         "dbrx-smoke": lambda: j_get_config("dbrx-132b", smoke=True),
         "kimi-smoke": lambda: j_get_config("kimi-k2-1t-a32b", smoke=True)}


@pytest.fixture(scope="module")
def setups():
    """name -> (jcfg, jax model, jax params, port cfg, port model, port
    params), fp32 activations and weights, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = CASES[name]().with_overrides(dtype="float32",
                                                param_dtype="float32")
            jm = get_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            pcfg = bridge.config_from_jax(jcfg)
            cache[name] = (jcfg, jm, jp, pcfg, Model(pcfg, device="cpu"),
                           bridge.params_from_jax(_np(jp), device="cpu"))
        return cache[name]
    return get


def _adapters(jcfg, seed, clients=None):
    """A numpy-seeded adapter tree with non-zero B, router included:
    single (leaves (P, d_in, r)) or, with ``clients``, a bank (P, C, d_in,
    r)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)

    def leaf(l):
        shape = l.shape if clients is None else (l.shape[0], clients) + \
            l.shape[1:]
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree.map(leaf, tmpl)


def test_router_adapter_shapes_follow_the_reference(setups):
    jcfg, *_ , pcfg, _, _ = setups("dbrx-smoke")
    ad = bridge.adapters_from_jax(_np(j_init_adapters(
        jax.random.PRNGKey(0), jcfg)), device="cpu")
    from repro_torch.core.lora import init_adapters
    mine = init_adapters(pcfg, device="cpu")
    want = {p: tuple(t.shape) for p, t in tree_leaves(ad)}
    assert {p: tuple(t.shape) for p, t in tree_leaves(mine)} == want
    assert ad["layers"][0]["mlp"]["router"]["b"].shape == \
        (pcfg.lora_rank, pcfg.n_experts)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_and_aux_with_a_banked_adapter_match_reference(
        setups, name):
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
    assert float(aj) > 0
    assert abs(float(ap) - float(aj)) <= 10 * AUX_TOL


def test_tied_moe_embeddings_are_not_scaled(setups):
    """The reference scales tied embeddings by sqrt(d) for the dense
    family only: an MoE model with tied embeddings reads them unscaled."""
    jcfg, jm, jp, pcfg, pm, pp = setups("tiny_moe_tied")
    from repro_torch.models import model as dec
    toks = torch.arange(6)[None]
    x = dec._embed(pp, toks, pcfg)
    torch.testing.assert_close(x, pp["embed"][toks], rtol=0, atol=0)


def test_prefill_with_binding_capacity_then_decode_match_reference(
        setups, monkeypatch):
    """One ragged chunk through bf16 pools at capacity factor 0.25 (cap
    64 for 3 × 40 tokens, top-2 of 4 experts): rows 0 and 1 feed 6 and 20
    tokens, so 54 padded tail positions come before row 2's 40 real ones
    in flat order; every padded position competes for capacity like a
    real token, and real tokens of row 2 are dropped behind them, in both
    packages.  Logits at every
    valid position and the pools against the reference's jnp paged
    branch, then a decode step."""
    jcfg, jm, jp, _, _, pp = setups("dbrx-smoke")
    jcfg = jcfg.with_overrides(moe_capacity_factor=0.25)
    jm = get_model(jcfg)
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    C, B, T, bs, NB, MB = 3, 3, 40, 4, 64, 16
    bank = _adapters(jcfg, 3, clients=C)
    jbank = jax.tree.map(jnp.asarray, bank)
    pbank = bridge.adapters_from_jax(bank, device="cpu")
    rng = np.random.default_rng(4)
    ids = np.asarray([1, 2, 0], np.int32)
    bt = np.stack([rng.permutation(np.arange(1 + 21 * b, 22 + 21 * b))[:MB]
                   for b in range(B)]).astype(np.int32)
    jc = jm.init_paged_decode_cache(B, NB, bs)
    pc = pm.init_paged_decode_cache(NB, bs)
    toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([4, 0, 0], np.int32)
    n_new = np.asarray([6, 20, 40], np.int32)
    toks[np.arange(T)[None, :] >= n_new[:, None]] = 0     # padded tails
    kept = []
    orig = moe.dispatch
    monkeypatch.setattr(moe, "dispatch",
                        lambda *a: kept.append(orig(*a)) or kept[-1])
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
    # capacity bound in the first layer: real tokens of row 2 lost copies
    # while padded positions of the rows before it kept theirs
    keep = kept[0][1].numpy().reshape(B, T, pcfg.n_experts_per_tok)
    assert (~keep[2]).any()
    assert keep[:2][~valid[:2]].any()
    for i, layer in enumerate(pc["layers"]):
        for name in ("k_pool", "v_pool"):
            want = np.asarray(jc["blocks"]["b0"][name][i], np.float32)
            np.testing.assert_allclose(layer[name].float().numpy()[1:],
                                       want[1:], atol=1e-2, rtol=2 ** -7)
            layer[name].copy_(torch.from_numpy(want))
    lens2 = lens + n_new
    step = np.asarray([[7], [11], [5]], np.int32)     # row 2 at 40
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


_JAX_STREAMS = {}


def _streams(setups, name, ranks, overlap):
    """(port streams, reference streams) of the same requests; the
    reference's are computed once per (config, ranks)."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    kw = dict(ranks=ranks) if ranks else {}
    jreg = JRegistry(jcfg, capacity=4, **kw)
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu", **kw)
    for i in range(3):
        jc = jcfg if not ranks else jcfg.with_overrides(
            lora_rank=ranks[i % len(ranks)])
        tree = _adapters(jc, 100 + i)
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    rng = np.random.default_rng(0)
    reqs = [(f"c{i % 3}", rng.integers(0, jcfg.vocab_size,
                                       int(rng.integers(5, 41)))
             .astype(np.int32), int(rng.integers(3, 9))) for i in range(6)]
    kw = dict(batch_size=4, max_new_tokens=8, prefill_chunk=8, block_size=4)
    key = (name, tuple(ranks or ()))
    if key not in _JAX_STREAMS:
        jout = JEngine(jm, jcfg, jp, jreg).generate(
            [JRequest(c, p, max_new_tokens=b) for c, p, b in reqs],
            JServeConfig(overlap=False, **kw))
        _JAX_STREAMS[key] = [list(map(int, o)) for o in jout]
    pout = MultiTenantEngine(pm, pcfg, pp, reg).generate(
        [Request(c, p, max_new_tokens=b) for c, p, b in reqs],
        ServeConfig(overlap=overlap, **kw))
    return [list(map(int, o)) for o in pout], _JAX_STREAMS[key]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", ["dbrx-smoke", "kimi-smoke"])
def test_greedy_streams_equal_the_reference_engine(setups, name, overlap):
    """3 tenants, 6 ragged requests (prompts of 5 to 40 tokens) over 4
    slots with 8-token chunks: the token streams are equal."""
    got, want = _streams(setups, name, None, overlap)
    assert got == want


def test_greedy_streams_over_a_ragged_bank_equal_the_reference(setups):
    """Clients at ranks 2 and 4 in a ragged bank: the router's adapter
    goes through each bucket at its own rank, as in the reference."""
    got, want = _streams(setups, "dbrx-smoke", [2, 4], True)
    assert got == want


@pytest.mark.parametrize("shards", [1, 2])
def test_kernel_view_of_a_ragged_int8_router_bank_reads_like_the_bank(
        setups, shards):
    """The kernel view (buckets concatenated at the largest rank, zero
    padded) gives the plain ``lora_delta`` the router update of the
    per-bucket bank it came from."""
    jcfg, *_, pcfg, _, _ = setups("dbrx-smoke")
    kw = dict(ranks=[2, 4], bank_dtype="int8", device="cpu")
    reg = (AdapterRegistry(pcfg, capacity=4, **kw) if shards == 1 else
           ShardedAdapterRegistry(pcfg, capacity=8, num_shards=2, **kw))
    for i, r in enumerate((2, 4, 2)):
        reg.register(f"c{i}", bridge.adapters_from_jax(
            _adapters(jcfg.with_overrides(lora_rank=r), 50 + i),
            device="cpu"))
    ids = torch.tensor([reg.acquire(f"c{i}") for i in (0, 1, 2, 0)],
                       dtype=torch.int32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 5, pcfg.d_model)).astype(np.float32))
    for layer, view in zip(reg.bank()["layers"], reg.kernel_bank()["layers"]):
        got = moe._router_delta(view["mlp"], x, ids)
        want = moe._router_delta(layer["mlp"], x, ids)
        assert isinstance(layer["mlp"]["router"]["a"], list)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert float(want.abs().max()) > 0


def test_train_step_loss_and_gradients_with_aux_match_reference(setups):
    """One dbrx-smoke LoRA train step: the loss (cross entropy plus the
    router's aux loss times its coefficient) and every adapter gradient,
    the router's included, against ``jax.value_and_grad``."""
    jcfg, jm, jp, pcfg, pm, pp = setups("dbrx-smoke")
    ad = _adapters(jcfg, 1)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (3, 32))
             .astype(np.int32),
             "loss_mask": (rng.random((3, 32)) < 0.7).astype(np.int32)}
    loss_fn = j_ts.make_lora_loss_fn(jm, jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, ad), jp, jax.tree.map(jnp.asarray, batch))
    loss, met, grads = lora_value_and_grad(pm, pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(met["aux_loss"]) > 0
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    assert float(loss) != pytest.approx(float(met["loss"]), abs=1e-3)
    got = dict(tree_leaves(grads))
    want = dict(tree_leaves(bridge.adapters_from_jax(_np(jg), device="cpu")))
    assert got.keys() == want.keys()
    assert any("router" in p for p in got)
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_each_moe_smoke_arch_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--tenants", "2",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "2 tenants, 4 ragged requests over 2 slots on cpu" in out
    streams = [ln for ln in out.splitlines() if ln.startswith("  client")]
    assert streams and all("[" in ln and "]" in ln for ln in streams)


def test_layers_lora_delta_is_the_router_path(setups):
    """The router's update is the plain ``layers.lora_delta`` on both
    backends: no kernel counter moves for it."""
    from repro_torch import kernels
    _, _, _, pcfg, _, pp = setups("dbrx-smoke")
    kernels.reset_launch_counts()
    x = torch.randn(2, 3, pcfg.d_model)
    a = torch.randn(2, pcfg.d_model, 4)
    b = torch.randn(2, 4, pcfg.n_experts)
    ids = torch.tensor([1, 0], dtype=torch.int32)
    torch.testing.assert_close(
        moe._router_delta({"router": {"a": a, "b": b}}, x, ids),
        L.lora_delta(x, a, b, ids))
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("int8", [False, True])
def test_paged_scatter_leaves_block_0_as_the_reference_does(int8):
    """Ragged tails and an idle row all write scratch block 0; the last
    write in (row, position) order wins each position, as in the
    reference's scatter, so the tail queries that read block 0 (and the
    MoE routing and capacity their hidden states feed) do not vary from
    run to run: the whole pools, block 0 included, equal the
    reference's."""
    from repro.kernels import paged_prefill as j_pp
    from repro_torch.kernels import paged_prefill as p_pp
    rng = np.random.default_rng(0)
    B, S, Kv, hd, NB, bs, MB = 4, 12, 2, 8, 20, 4, 4
    k, v = (rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
            for _ in range(2))
    bt = np.zeros((B, MB), np.int32)
    bt[0, :3], bt[1], bt[2, :2] = [1, 2, 3], [4, 5, 6, 7], [8, 9]
    lens = np.asarray([2, 0, 1, 0], np.int32)
    n_new = np.asarray([5, 12, 3, 0], np.int32)
    shapes = [(NB, bs, Kv, hd)] * 2 + ([(NB, bs, Kv)] * 2 if int8 else [])
    dtypes = ([np.int8] * 2 + [np.float32] * 2) if int8 else [np.float32] * 2
    args = (k, v, bt, lens, n_new)
    fn = "paged_scatter_quant" if int8 else "paged_scatter"
    want = getattr(j_pp, fn)(
        *[jnp.zeros(s, d) for s, d in zip(shapes, dtypes)],
        *map(jnp.asarray, args))
    got = [torch.zeros(s, dtype=torch.from_numpy(np.zeros(1, d)).dtype)
           for s, d in zip(shapes, dtypes)]
    getattr(p_pp, fn)(*got, *map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.abs(got[0].numpy()[0]).max() > 0


def test_fedrod_adds_both_forwards_aux_loss_like_the_reference(
        setups, monkeypatch):
    """FedRoD's loss adds the router's aux loss of both its forwards, as
    the reference's does: one round of FedRoD on ``tiny_moe`` from the
    reference's initial adapters and the same batches gives the same
    adapters (each leaf after one AdamW step within 1e-2 of lr)."""
    from repro.data import synthetic as j_synth
    from repro.data.pipeline import SFTBatcher as JBatcher
    from repro.data.tokenizer import ByteTokenizer as JTokenizer
    from repro.federated import baselines as j_base
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.federated import baselines
    jcfg, jm, jp, pcfg, pm, pp = setups("tiny_moe")
    monkeypatch.setattr(
        baselines, "init_adapters",
        lambda cfg, rank=None, seed=0, device="cuda":
        bridge.adapters_from_jax(_np(j_init_adapters(
            jax.random.PRNGKey(seed), jcfg, rank=rank)), device))

    def batchers(cls, tok):
        rng = np.random.default_rng(1)
        return [cls(j_synth.gen_log_dataset(rng, 16, i), tok, 128, 4, seed=i)
                for i in range(2)]
    fed = dict(n_clients=2, rounds=1, local_steps=1)
    jb = j_base.BASELINES["fedrod"](jm, jcfg, j_base.FedConfig(**fed), jp)
    jads = jb.fit(batchers(JBatcher, JTokenizer()))
    pb = baselines.BASELINES["fedrod"](pm, pcfg, baselines.FedConfig(**fed),
                                       pp, device="cpu")
    pads = pb.fit(batchers(SFTBatcher, ByteTokenizer()))
    tol = 1e-2 * pb.fed.lr
    for pa, ja in zip(pads, jads):
        got = dict(tree_leaves(pa))
        want = dict(tree_leaves(bridge.adapters_from_jax(_np(ja),
                                                         device="cpu")))
        assert got.keys() == want.keys() and any("router" in p for p in got)
        for path in got:
            np.testing.assert_allclose(got[path].detach().numpy(),
                                       want[path].numpy(), atol=tol,
                                       rtol=1e-4, err_msg=path)

"""The port's dense model against the reference ``Model`` on the CPU.

Weights come from the reference init, bridged as numpy; adapters are
numpy-seeded with a NON-ZERO B (a zero B would hide any LoRA fault).  Both
packages compute in fp32 on ``tiny_dense`` (H=4, Kv=2: GQA groups of 2);
the paged pools are bf16 in both, as in serving.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro_torch import bridge
from repro_torch.models.api import Model

# fp32 on both sides: matmul and softmax summation orders differ, nothing
# else (logits here are O(1))
LOGIT_TOL = 1e-4


def _setup(**cfg_kw):
    jcfg = tiny_dense(dtype="float32", param_dtype="float32", **cfg_kw)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = Model(bridge.config_from_jax(jcfg), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, pm, pp


def _adapters(jcfg, seed, clients=None):
    """A numpy-seeded adapter tree with non-zero B: single (leaves
    (P, d_in, r)) or, with ``clients``, a bank (P, C, d_in, r)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)

    def leaf(l):
        shape = l.shape if clients is None else (l.shape[0], clients) + \
            l.shape[1:]
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree.map(leaf, tmpl)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("banked", [False, True])
def test_forward_logits_match_reference(tied, banked):
    jcfg, jm, jp, pm, pp = _setup(tie_embeddings=tied)
    ad = _adapters(jcfg, 1, clients=3 if banked else None)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 10))
    ids = np.asarray([2, 0, 1], np.int32) if banked else None
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       jax.tree.map(jnp.asarray, ad), 2.0,
                       adapter_ids=None if ids is None else jnp.asarray(ids))
    lp, aux = pm.forward(pp, {"tokens": torch.from_numpy(toks)},
                         bridge.adapters_from_jax(ad, device="cpu"), 2.0,
                         adapter_ids=None if ids is None else
                         torch.from_numpy(ids))
    assert lp.shape == (3, 10, jcfg.vocab_size) and lp.dtype == torch.float32
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=LOGIT_TOL)
    assert float(aux) == 0.0


def _pool_np(jcache, name):
    # reference pools stacked on the period axis, bf16
    return np.asarray(jcache["blocks"]["b0"][name], np.float32)


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
def test_prefill_then_decode_logits_and_pools_match_reference(jax_backend):
    """A ragged prefill chunk (one row past its prompt end, one inactive
    row) then one decode step, through banked adapters: logits at every
    valid position and the bf16 pools against the reference on both of its
    paged backends (``"pallas"`` runs the kernels in interpret mode)."""
    jcfg, jm, jp, pm, pp = _setup()
    C, B, T, bs, NB, MB = 3, 3, 5, 4, 16, 4
    bank = _adapters(jcfg, 3, clients=C)
    jbank = jax.tree.map(jnp.asarray, bank)
    pbank = bridge.adapters_from_jax(bank, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    ids = np.asarray([1, 2, 0], np.int32)
    bt = np.zeros((B, MB), np.int32)
    bt[0] = [3, 7, 1, 9]
    bt[1] = [2, 5, 0, 0]
    lens = np.asarray([2, 0, 0], np.int32)
    n_new = np.asarray([5, 3, 0], np.int32)           # row 2 inactive
    jc = jm.init_paged_decode_cache(B, NB, bs)
    pc = pm.init_paged_decode_cache(NB, bs)
    # some earlier context for row 0 (positions 0..1), identical in both
    ctx = rng.standard_normal((2, bs, jcfg.n_kv_heads,
                               jcfg.resolved_head_dim)).astype(np.float32)
    ctx_bf = np.asarray(jnp.asarray(ctx).astype(jnp.bfloat16), np.float32)
    for name in ("k_pool", "v_pool"):
        jc["blocks"]["b0"][name] = jc["blocks"]["b0"][name].at[:, 3].set(
            jnp.asarray(ctx_bf[0]).astype(jnp.bfloat16))
        for layer in pc["layers"]:
            layer[name][3] = torch.from_numpy(ctx_bf[0]).to(torch.bfloat16)
    common = dict(lora_scale=2.0)
    lj, jc = jm.prefill_step(jp, jc, jnp.asarray(toks), jnp.asarray(lens),
                             jnp.asarray(n_new), adapters=jbank,
                             adapter_ids=jnp.asarray(ids),
                             block_tables=jnp.asarray(bt),
                             paged_backend=jax_backend, **common)
    lp, pc = pm.prefill_step(pp, pc, torch.from_numpy(toks),
                             torch.from_numpy(lens), torch.from_numpy(n_new),
                             adapters=pbank, adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt),
                             paged_backend="torch", **common)
    valid = np.arange(T)[None, :] < n_new[:, None]
    # the Pallas kernels round attention probabilities to the bf16 pool
    # dtype before the value product; the jnp path keeps fp32
    tol = LOGIT_TOL if jax_backend == "jnp" else 2e-3
    np.testing.assert_allclose(lp.numpy()[valid], np.asarray(lj)[valid],
                               atol=tol)
    for name in ("k_pool", "v_pool"):
        want = _pool_np(jc, name)
        for i, layer in enumerate(pc["layers"]):
            # block 0 is scratch (ragged tails land there in any order)
            np.testing.assert_allclose(layer[name].float().numpy()[1:],
                                       want[i][1:], atol=1e-2, rtol=1e-2)
    # one decode step for the two live rows
    lens2 = lens + n_new
    step = np.asarray([[7], [11], [0]], np.int32)
    lj2, jc = jm.decode_step(jp, jc, jnp.asarray(step), jnp.asarray(lens2),
                             adapters=jbank, adapter_ids=jnp.asarray(ids),
                             block_tables=jnp.asarray(bt),
                             paged_backend=jax_backend, **common)
    lp2, pc = pm.decode_step(pp, pc, torch.from_numpy(step),
                             torch.from_numpy(lens2), adapters=pbank,
                             adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt),
                             paged_backend="torch", **common)
    np.testing.assert_allclose(lp2.numpy()[:2], np.asarray(lj2)[:2], atol=tol)


def test_pool_writes_round_to_bf16_exactly_like_reference():
    """The bf16 pools hold bitwise what the reference writes on its jnp
    path (same rounding of the same fp32 K/V), decode step by decode step."""
    jcfg, jm, jp, pm, pp = _setup()
    B, bs, NB = 2, 4, 6
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    jc = jm.init_paged_decode_cache(B, NB, bs)
    pc = pm.init_paged_decode_cache(NB, bs)
    lens = np.asarray([0, 0], np.int32)
    for tok in ([5, 9], [17, 3], [250, 1]):
        step = np.asarray(tok, np.int32)[:, None]
        _, jc = jm.decode_step(jp, jc, jnp.asarray(step), jnp.asarray(lens),
                               block_tables=jnp.asarray(bt),
                               paged_backend="jnp")
        _, pc = pm.decode_step(pp, pc, torch.from_numpy(step),
                               torch.from_numpy(lens),
                               block_tables=torch.from_numpy(bt))
        lens = lens + 1
    for name in ("k_pool", "v_pool"):
        want = _pool_np(jc, name)
        for i, layer in enumerate(pc["layers"]):
            got = layer[name].float().numpy()
            np.testing.assert_allclose(got, want[i], atol=2 ** -7, rtol=2 ** -7)


def test_cuda_backend_and_device_are_refused_on_the_cpu():
    jcfg, jm, jp, pm, pp = _setup()
    cache = pm.init_paged_decode_cache(4, 4)
    bt = torch.tensor([[1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU allows only 'torch'"):
        pm.decode_step(pp, cache, torch.tensor([[1]]), torch.tensor([0]),
                       block_tables=bt, paged_backend="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Model(pm.cfg)                              # default device: cuda


def test_int8_kv_pools_are_a_later_slice():
    """The int8 pool layout equals the reference's: int8 pools and fp32
    (NB, bs, Kv) scale leaves; an unknown dtype is refused."""
    jcfg, jm, _, pm, _ = _setup()
    jc = jm.init_paged_decode_cache(2, 5, 4, kv_dtype="int8")["blocks"]["b0"]
    pc = pm.init_paged_decode_cache(5, 4, kv_dtype="int8")["layers"]
    assert len(pc) == jcfg.n_layers
    for name, leaf in jc.items():
        assert pc[0][name].dtype == (torch.int8 if leaf.dtype == jnp.int8
                                     else torch.float32)
        assert tuple(pc[0][name].shape) == tuple(leaf.shape[1:])
    with pytest.raises(ValueError, match="kv_dtype"):
        pm.init_paged_decode_cache(4, 4, kv_dtype="fp8")


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
def test_int8_prefill_then_decode_matches_reference(jax_backend):
    """int8 K/V through a ragged prefill chunk and one decode step, banked
    adapters: logits against the reference's int8 path on both of its
    paged backends, and the int8 pools and scales it wrote."""
    jcfg, jm, jp, pm, pp = _setup()
    C, B, T, bs, NB, MB = 3, 3, 5, 4, 16, 4
    bank = _adapters(jcfg, 5, clients=C)
    jbank = jax.tree.map(jnp.asarray, bank)
    pbank = bridge.adapters_from_jax(bank, device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    ids = np.asarray([1, 2, 0], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [2, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([0, 0, 0], np.int32)
    n_new = np.asarray([5, 3, 0], np.int32)
    jc = jm.init_paged_decode_cache(B, NB, bs, kv_dtype="int8")
    pc = pm.init_paged_decode_cache(NB, bs, kv_dtype="int8")
    common = dict(lora_scale=2.0)
    lj, jc = jm.prefill_step(jp, jc, jnp.asarray(toks), jnp.asarray(lens),
                             jnp.asarray(n_new), adapters=jbank,
                             adapter_ids=jnp.asarray(ids),
                             block_tables=jnp.asarray(bt),
                             paged_backend=jax_backend, **common)
    lp, pc = pm.prefill_step(pp, pc, torch.from_numpy(toks),
                             torch.from_numpy(lens), torch.from_numpy(n_new),
                             adapters=pbank, adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt), **common)
    valid = np.arange(T)[None, :] < n_new[:, None]
    # the Pallas kernels round attention probabilities before the value
    # product; the jnp path keeps fp32
    tol = LOGIT_TOL if jax_backend == "jnp" else 2e-3
    np.testing.assert_allclose(lp.numpy()[valid], np.asarray(lj)[valid],
                               atol=tol)
    for name in ("k_scale", "v_scale", "k_pool", "v_pool"):
        want = np.asarray(jc["blocks"]["b0"][name], np.float32)
        for i, layer in enumerate(pc["layers"]):
            got = layer[name].float().numpy()[1:]
            # scales agree to fp32 noise; an int8 value may sit on the other
            # side of a rounding boundary, one step away
            atol = 1e-5 if "scale" in name else 1.0
            np.testing.assert_allclose(got, want[i][1:], atol=atol)
    lens2 = lens + n_new
    step = np.asarray([[7], [11], [0]], np.int32)
    lj2, jc = jm.decode_step(jp, jc, jnp.asarray(step), jnp.asarray(lens2),
                             adapters=jbank, adapter_ids=jnp.asarray(ids),
                             block_tables=jnp.asarray(bt),
                             paged_backend=jax_backend, **common)
    lp2, pc = pm.decode_step(pp, pc, torch.from_numpy(step),
                             torch.from_numpy(lens2), adapters=pbank,
                             adapter_ids=torch.from_numpy(ids),
                             block_tables=torch.from_numpy(bt), **common)
    np.testing.assert_allclose(lp2.numpy()[:2], np.asarray(lj2)[:2], atol=tol)


@pytest.mark.parametrize("fn", ["to_torch", "unstack_blocks",
                                "params_from_jax", "adapters_from_jax"])
def test_bridge_defaults_to_the_card(fn):
    """The bridge puts its tensors on the card unless asked for the CPU,
    like every entry point of the port: without a card the default raises,
    and ``device="cpu"`` works."""
    jcfg, jm, jp, pm, pp = _setup()
    tree = jax.tree.map(np.asarray, jp)
    arg = {"to_torch": tree["embed"], "unstack_blocks": tree["blocks"],
           "params_from_jax": tree,
           "adapters_from_jax": _adapters(jcfg, 1)}[fn]
    out = getattr(bridge, fn)(arg, device="cpu")
    first = out if fn == "to_torch" else (
        out[0] if fn == "unstack_blocks" else out["layers"][0])
    leaf = first if fn == "to_torch" else next(
        iter(next(iter(first.values())).values()))
    if isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    assert leaf.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            getattr(bridge, fn)(arg)

"""The VLM and encoder-decoder families (internvl2-26b, whisper-small)
through the port against the reference package on the CPU.

The configs field by field (full and smoke) and their parameter counts;
the adapter trees' shapes; LoRA zero-init; forward logits with patch
embeddings and with encoder frames on the tiny ``vlm`` and ``encdec``
configs of ``tests/test_models.py`` and on both smoke configs; a train
step (the VLM's loss skips its patch positions; the encoder-decoder's
cross-attention ``wv`` adapter, never read, gets a zero gradient);
``prefill_cross`` then ``decode_step`` against the reference's decode
steps and the port's forward; the encoder-decoder's refusals in
``models/api.py``; internvl2-smoke's greedy engine streams; both CLIs.
Weights come from the reference init, bridged; adapters are numpy-seeded
with a non-zero B; activations fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models import encdec as j_encdec
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.lora import init_adapters, tree_leaves
from repro_torch.models import encdec
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.training.train_step import lora_value_and_grad

ARCHS = ["internvl2-26b", "whisper-small"]
# the tolerances of tests/test_torch_ssm.py: fp32 summation order on O(1)
# logits; a train step
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# decode steps read bf16 ring buffers and bf16 cross K/V where the forward
# reads them unrounded: the reference test's bound
DECODE_VS_FORWARD_TOL = 0.05

CASES = {
    # the vlm and encdec configs of tests/test_models.py
    "vlm": lambda: tiny_dense(name="vlm", family="vlm", n_patch_tokens=8),
    "encdec": lambda: tiny_dense(
        name="ed", family="encdec", n_kv_heads=4, norm_type="layernorm",
        mlp_type="gelu", use_rope=False, tie_embeddings=True,
        n_encoder_layers=2, encoder_seq_len=24,
        lora_targets=("wq", "wv", "w_up", "w_out")),
    "internvl2-smoke": lambda: j_get_config("internvl2-26b", smoke=True),
    "whisper-smoke": lambda: j_get_config("whisper-small", smoke=True),
}
ENCDEC = ["encdec", "whisper-smoke"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
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


def _adapters(jcfg, seed):
    """A numpy-seeded adapter tree with non-zero B in the reference
    layout."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def _batch(jcfg, B=2, S=16, seed=2):
    """Tokens, a loss mask and the family's stub embeddings (numpy)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.7).astype(np.int32)}
    if jcfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.is_encdec:
        b["enc_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return b


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


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
    assert got.is_encdec == jcfg.is_encdec == (arch == "whisper-small")
    assert arch in ALL_ARCHS


@pytest.mark.parametrize("arch,want", [("internvl2-26b", 19_861_254_144),
                                       ("whisper-small", 264_377_088)])
def test_parameter_counts_equal_the_reference(arch, want):
    """whisper-small's count copies the reference's encdec terms (a
    cross-attention per ENCODER layer, positions at max_seq_len)."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert cfg.count_params() == jcfg.count_params() == want
    assert cfg.count_lora_params() == jcfg.count_lora_params()


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vlm", "encdec", "whisper-smoke"])
def test_adapter_shapes_follow_the_reference(setups, name):
    """The encoder-decoder's tree is the reference's: ``enc_blocks``
    {self_attn, mlp} and ``dec_blocks`` {self_attn, cross_attn, mlp},
    leaves stacked over each stack's depth; the VLM's is the dense one."""
    jcfg, *_, pcfg, _, _ = setups(name)
    want = {p: tuple(t.shape) for p, t in tree_leaves(
        bridge.adapters_from_jax(_np(j_init_adapters(
            jax.random.PRNGKey(0), jcfg)), device="cpu"))}
    got = {p: tuple(t.shape) for p, t in tree_leaves(
        init_adapters(pcfg, device="cpu"))}
    assert got == want
    if pcfg.is_encdec:
        assert "['dec_blocks']['cross_attn']['wv']['a']" in got


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_lora_zero_init_is_the_base_model(setups, name):
    jcfg, _, _, pcfg, pm, pp = setups(name)
    b = _tb(_batch(jcfg))
    base, _ = pm.forward(pp, b)
    with_lora, _ = pm.forward(pp, b, init_adapters(pcfg, device="cpu"), 2.0)
    np.testing.assert_allclose(with_lora.numpy(), base.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# forward and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_match_reference(setups, name):
    """Patch embeddings prepended (the logits cover P + S positions) or
    encoder frames read through cross-attention."""
    jcfg, jm, jp, _, pm, pp = setups(name)
    ad = _adapters(jcfg, 1)
    b = _batch(jcfg)
    lj, _ = jax.jit(lambda p, b, a: jm.forward(p, b, a, 2.0))(
        jp, _jb(b), jax.tree.map(jnp.asarray, ad))
    lp, aux = pm.forward(pp, _tb(b), bridge.adapters_from_jax(
        ad, device="cpu"), 2.0)
    S = 16 + (jcfg.n_patch_tokens if jcfg.family == "vlm" else 0)
    assert lp.shape == (2, S, jcfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=LOGIT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_loss_and_gradients_match_reference(setups, name):
    """The loss over the text positions only (the VLM's shift past its
    patches) and every adapter gradient against ``jax.value_and_grad``;
    the encoder-decoder's cross-attention ``wv`` gradient is exactly 0 on
    both sides (its adapter is never read)."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    ad = _adapters(jcfg, 1)
    b = _batch(jcfg)
    loss_fn = j_ts.make_lora_loss_fn(jm, jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, ad), jp, _jb(b))
    loss, met, grads = lora_value_and_grad(pm, pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"), _tb(b))
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    assert float(met["tokens"]) == float(jmet["tokens"])
    got = dict(tree_leaves(grads))
    want = dict(tree_leaves(bridge.adapters_from_jax(_np(jg), device="cpu")))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)
    if pcfg.is_encdec:
        for k in ("a", "b"):
            path = f"['dec_blocks']['cross_attn']['wv'][{k!r}]"
            assert torch.equal(got[path], torch.zeros_like(got[path]))
            assert not np.any(want[path].numpy())
        assert float(got["['dec_blocks']['cross_attn']['wq']['b']"]
                     .abs().max()) > 0


def test_encdec_takes_a_dual_tree_as_its_eq7_merge(setups):
    """A fused evaluation's dual tree (both pairs and the shared fusion
    weights per target) through the stacked layers equals the merged
    tree: each layer reads its slice of the pairs and the whole of w."""
    from repro_torch.core.dual_lora import dual_tree, merge
    jcfg, *_, pcfg, pm, pp = setups("encdec")
    p, g = (bridge.adapters_from_jax(_adapters(jcfg, s), device="cpu")
            for s in (4, 5))
    b = _tb(_batch(jcfg))
    want, _ = pm.forward(pp, b, merge(p, g, [0.7, 0.4]), 2.0)
    got, _ = pm.forward(pp, b, dual_tree(p, g, [0.7, 0.4]), 2.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)


def test_vlm_loss_reads_only_the_text_positions(setups):
    """Moving the patch positions' logits leaves the loss unchanged."""
    from repro_torch.training.train_step import cross_entropy
    jcfg, *_, pcfg, pm, pp = setups("vlm")
    b = _tb(_batch(jcfg))
    logits, _ = pm.forward(pp, b)
    loss, _ = cross_entropy(pcfg, logits, b)
    moved = logits.clone()
    moved[:, :pcfg.n_patch_tokens] += 7.0
    assert float(cross_entropy(pcfg, moved, b)[0]) == float(loss)


# ---------------------------------------------------------------------------
# the encoder-decoder's decode path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ENCDEC)
def test_prefill_cross_then_decode_steps_match_reference_and_forward(
        setups, name):
    """``prefill_cross`` fills the bf16 cross K/V, then 8 ``decode_step``
    calls through bf16 ring buffers: the logits of each step equal the
    reference's decode step's, and the port's forward over the same
    tokens within the reference test's bound."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    ad = _adapters(jcfg, 3)
    jad = jax.tree.map(jnp.asarray, ad)
    pad = bridge.adapters_from_jax(ad, device="cpu")
    b = _batch(jcfg, S=8)
    full, _ = pm.forward(pp, _tb(b), pad, 2.0)
    jc = jm.init_decode_cache(2, 8)
    jc["cross_k"], jc["cross_v"] = j_encdec.prefill_cross(
        jp, jnp.asarray(b["enc_embeds"]), jcfg, jad, 2.0)
    pc = pm.init_decode_cache(2, 8)
    pc["cross_k"], pc["cross_v"] = encdec.prefill_cross(
        pp, torch.from_numpy(b["enc_embeds"]), pcfg, pad, 2.0)
    assert pc["cross_k"].dtype == torch.bfloat16
    assert pc["cross_k"].shape == (pcfg.n_layers, 2, pcfg.encoder_seq_len,
                                   pcfg.n_kv_heads, pcfg.resolved_head_dim)
    np.testing.assert_allclose(pc["cross_k"].float().numpy(),
                               np.asarray(jc["cross_k"], np.float32),
                               atol=1e-2, rtol=2 ** -7)
    step = jax.jit(lambda p, c, t, n, a: jm.decode_step(
        p, c, t, n, adapters=a, lora_scale=2.0))
    for t in range(8):
        tok = b["tokens"][:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(t), jad)
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(tok), t,
                                adapters=pad, lora_scale=2.0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, err_msg=f"step {t}")
        assert float((pl[:, 0] - full[:, t]).abs().max()) < \
            DECODE_VS_FORWARD_TOL
    assert pc["self"]["pos"] == 8


def test_decode_cache_bridges_from_the_reference(setups):
    jcfg, jm, *_ = setups("encdec")
    pc = bridge.adapters_from_jax(_np(jm.init_decode_cache(3, 5)),
                                  device="cpu")
    want = Model(bridge.config_from_jax(jcfg), "cpu").init_decode_cache(3, 5)
    assert pc["self"]["pos"] == want["self"]["pos"] == 0
    for k in ("cross_k", "cross_v"):
        assert pc[k].shape == want[k].shape and pc[k].dtype == want[k].dtype
    for k in ("k", "v"):
        assert pc["self"][k].shape == want["self"][k].shape


@pytest.mark.parametrize("call", ["banked_forward", "paged_cache",
                                  "paged_prefill", "paged_decode"])
def test_encdec_refuses_what_the_reference_refuses(setups, call):
    jcfg, *_, pcfg, pm, pp = setups("encdec")
    ids = torch.zeros((2,), dtype=torch.int32)
    toks = torch.zeros((2, 1), dtype=torch.int32)
    calls = {
        "banked_forward": lambda: pm.forward(pp, _tb(_batch(jcfg)),
                                             adapter_ids=ids),
        "paged_cache": lambda: pm.init_paged_decode_cache(4, 4),
        "paged_prefill": lambda: pm.prefill_step(
            pp, {}, toks, ids, ids, block_tables=ids[:, None]),
        "paged_decode": lambda: pm.decode_step(
            pp, pm.init_decode_cache(2, 4), toks, ids,
            block_tables=ids[:, None]),
    }
    with pytest.raises(NotImplementedError, match="decoder-family only"):
        calls[call]()


# ---------------------------------------------------------------------------
# serving and the CLIs
# ---------------------------------------------------------------------------

def _requests(jcfg, n=5):
    rng = np.random.default_rng(0)
    return [(f"c{i % 3}", rng.integers(0, jcfg.vocab_size,
                                       int(rng.integers(5, 30)))
             .astype(np.int32), int(rng.integers(3, 8))) for i in range(n)]


@pytest.mark.parametrize("overlap", [True, False])
def test_internvl2_greedy_streams_equal_the_reference_engine(setups,
                                                             overlap):
    """Text-only requests (no patches), as the reference serves the VLM:
    3 tenants, 5 ragged requests over 4 slots, 8-token chunks."""
    jcfg, jm, jp, pcfg, pm, pp = setups("internvl2-smoke")
    jreg = JRegistry(jcfg, capacity=4)
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    for i in range(3):
        tree = _adapters(jcfg, 100 + i)
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    sc = dict(batch_size=4, max_new_tokens=8, prefill_chunk=8, block_size=4)
    reqs = _requests(jcfg)
    want = JEngine(jm, jcfg, jp, jreg).generate(
        [JRequest(c, p, max_new_tokens=n) for c, p, n in reqs],
        JServeConfig(overlap=False, **sc))
    got = MultiTenantEngine(pm, pcfg, pp, reg).generate(
        [Request(c, p, max_new_tokens=n) for c, p, n in reqs],
        ServeConfig(overlap=overlap, **sc))
    assert [list(map(int, o)) for o in got] == \
        [list(map(int, o)) for o in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_arch_on_cpu(arch, tmp_path, capsys):
    """Stub embeddings fed beside the text; the adapters saved in the
    reference's npz layout load back in both packages with the same
    shapes."""
    from repro.training.checkpoint import load_checkpoint as j_load
    from repro_torch.launch.train import main
    from repro_torch.training.checkpoint import load_checkpoint
    ckpt = str(tmp_path / "ad.npz")
    adapters = main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "48",
                     "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "feeding stub embeddings" in out and "step    1" in out
    assert all(bool(torch.isfinite(t).all())
               for _, t in tree_leaves(adapters))
    shapes = {p: tuple(t.shape) for p, t in tree_leaves(adapters)}
    assert {p: tuple(t.shape) for p, t in tree_leaves(
        load_checkpoint(ckpt, device="cpu"))} == shapes
    assert {p: tuple(t.shape) for p, t in tree_leaves(
        bridge.adapters_from_jax(_np(j_load(ckpt)), device="cpu"))} == shapes


def test_serve_cli_serves_internvl2_and_refuses_whisper(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "internvl2-26b", "--smoke", "--device", "cpu",
          "--tenants", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "2 tenants, 4 ragged requests over 2 slots on cpu" in out
    with pytest.raises(SystemExit, match="enc-dec serving needs audio"):
        main(["--arch", "whisper-small", "--smoke", "--device", "cpu"])

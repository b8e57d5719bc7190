"""The port's federated baselines and ``answer_accuracy`` against the
reference package on the CPU.

Each of the seven baselines runs through both packages with
``FedConfig(n_clients=2, rounds=2, local_steps=1)`` on ``tiny_dense`` in
fp32: the port's initial adapters are the reference's, bridged through a
monkeypatched ``init_adapters``, and both packages see the same
``SFTBatcher`` batches, so the returned adapters agree to ``leaf_tol`` and
the communicated bytes are equal.  The JAX file's own contract cases
(FedAvg clients share a model, Local clients differ, FedKD communicates
less than FedAvg, ``concat_rank`` is an exact sum) run on the port, and
``answer_accuracy`` is held equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.data import synthetic as j_synth
from repro.data.pipeline import SFTBatcher as JBatcher
from repro.data.tokenizer import ByteTokenizer as JTokenizer
from repro.federated import baselines as j_base
from repro.models.api import get_model
from repro_torch import bridge
from repro_torch.core.lora import init_adapters, tree_leaves
from repro_torch.data import synthetic
from repro_torch.data.pipeline import SFTBatcher
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.federated import baselines
from repro_torch.models.api import Model

# fp32 on both sides from the same inputs: only summation order differs
# (copied from tests/test_torch_training.py)
LOSS_TOL = 1e-5


def leaf_tol(lr: float, steps: int) -> float:
    """Adapters after AdamW steps: Adam divides by sqrt(v) + eps, so a
    gradient element not far above eps carries its fp32 summation noise
    into an update of up to lr in size; 1e-2 of lr per step bounds it."""
    return 1e-2 * lr * steps


FED = dict(n_clients=2, rounds=2, local_steps=1)


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, pcfg, pm, pp


def _batchers(cls, tok, n=2):
    """Batches long enough (128) to hold every log prompt and its answer,
    so that the loss reads answer tokens."""
    rng = np.random.default_rng(1)
    out = [cls(j_synth.gen_log_dataset(rng, 16, i), tok, 128, 4, seed=i)
           for i in range(n)]
    assert all(b.data["loss_mask"].sum(1).min() >= 2 for b in out)
    return out


def _leaves_np(tree):
    return [np.asarray(t.detach(), np.float32) for _, t in tree_leaves(tree)]


@pytest.fixture
def bridged(setup, monkeypatch):
    """The port's ``init_adapters`` draws the reference's adapters."""
    jcfg = setup[0]

    def bridged_init(cfg, rank=None, seed=0, device="cuda"):
        ad = j_init_adapters(jax.random.PRNGKey(seed), jcfg, rank=rank)
        return bridge.adapters_from_jax(jax.tree.map(np.asarray, ad), device)
    monkeypatch.setattr(baselines, "init_adapters", bridged_init)


def _assert_adapters_close(port, jtree, atol):
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, jtree),
                                    device="cpu")
    got, exp = dict(tree_leaves(port)), dict(tree_leaves(want))
    assert got.keys() == exp.keys()
    for path in got:
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   exp[path].numpy(), atol=atol, rtol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(baselines.BASELINES))
def test_baseline_matches_reference(name, setup, bridged):
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = baselines.FedConfig(**FED)
    jb = j_base.BASELINES[name](jm, jcfg, j_base.FedConfig(**FED), jp)
    jads = jb.fit(_batchers(JBatcher, JTokenizer()))
    pb = baselines.BASELINES[name](pm, pcfg, fed, pp, device="cpu")
    assert pb.paged_backend == "torch"
    pads = pb.fit(_batchers(SFTBatcher, ByteTokenizer()))
    assert len(pads) == len(jads) == 2
    # every leaf went through rounds * local_steps AdamW steps
    tol = leaf_tol(fed.lr, fed.rounds * fed.local_steps)
    for pa, ja in zip(pads, jads):
        assert all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(pa))
        _assert_adapters_close(pa, ja, tol)
    assert pb.comm_bytes == jb.comm_bytes
    if name == "local":
        assert pb.comm_bytes == 0.0
    else:
        assert pb.comm_bytes > 0
    if name == "fedrod":
        # the returned adapters are rank 2r (the generic and the personal
        # pair), run at the config's scale
        assert pads[0]["layers"][0]["mixer"]["wq"]["a"].shape[1] == \
            2 * pcfg.lora_rank
        _assert_adapters_close(pb._final_g, jb._final_g, tol)


def test_fedavg_clients_share_model(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = baselines.FedConfig(n_clients=2, rounds=1, local_steps=1)
    ads = baselines.BASELINES["fedavg"](pm, pcfg, fed, pp,
                                        device="cpu").fit(
        _batchers(SFTBatcher, ByteTokenizer()))
    for a, b in zip(_leaves_np(ads[0]), _leaves_np(ads[1])):
        np.testing.assert_array_equal(a, b)


def test_local_clients_differ(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = baselines.FedConfig(n_clients=2, rounds=1, local_steps=2)
    ads = baselines.BASELINES["local"](pm, pcfg, fed, pp, device="cpu").fit(
        _batchers(SFTBatcher, ByteTokenizer()))
    same = all(np.allclose(a, b) for a, b in
               zip(_leaves_np(ads[0]), _leaves_np(ads[1])))
    assert not same


def test_fedkd_communicates_less_than_fedavg(setup):
    """FedKD ships only the rank-r/2 student: bytes must be < FedAvg's."""
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = baselines.FedConfig(n_clients=2, rounds=2, local_steps=1)
    avg = baselines.BASELINES["fedavg"](pm, pcfg, fed, pp, device="cpu")
    avg.fit(_batchers(SFTBatcher, ByteTokenizer()))
    kd = baselines.BASELINES["fedkd"](pm, pcfg, fed, pp, device="cpu")
    kd.fit(_batchers(SFTBatcher, ByteTokenizer()))
    assert 0 < kd.comm_bytes < avg.comm_bytes


def test_concat_rank_is_exact_sum(setup):
    """(A1|A2)(B1;B2) == A1B1 + A2B2 — the FedRoD/FedKD composition, and
    the port's concatenation is the reference's leaf for leaf."""
    pcfg = setup[3]
    g = init_adapters(pcfg, seed=3, device="cpu", b_std=0.1)
    p = init_adapters(pcfg, rank=2, seed=4, device="cpu", b_std=0.2)
    cat = baselines.concat_rank(g, p)
    for gl, pl, cl in zip(g["layers"], p["layers"], cat["layers"]):
        for part in gl:
            for t in gl[part]:
                a, b = gl[part][t], pl[part][t]
                c = cl[part][t]
                assert c["a"].shape[1] == a["a"].shape[1] + b["a"].shape[1]
                direct = a["a"] @ a["b"] + b["a"] @ b["b"]
                torch.testing.assert_close(c["a"] @ c["b"], direct,
                                           atol=1e-5, rtol=1e-5)
    # the reference's concatenation of the same trees, bridged
    jg = j_init_adapters(jax.random.PRNGKey(3), setup[0])
    jp_ = j_init_adapters(jax.random.PRNGKey(4), setup[0], rank=2)
    jcat = j_base.concat_rank(jg, jp_)
    pcat = baselines.concat_rank(
        bridge.adapters_from_jax(jax.tree.map(np.asarray, jg), "cpu"),
        bridge.adapters_from_jax(jax.tree.map(np.asarray, jp_), "cpu"))
    _assert_adapters_close(pcat, jcat, 0.0)


def test_fedrep_split_walks_the_layer_list(setup):
    """FedRep shares the attention adapters of every layer and keeps every
    MLP adapter personal; split then merge gives the tree back."""
    pcfg = setup[3]
    ad = init_adapters(pcfg, seed=5, device="cpu", b_std=0.1)
    shared, head = baselines._split_rep_head(ad)
    assert [set(layer) for layer in shared["layers"]] == \
        [{"mixer"}] * pcfg.n_layers
    assert [set(layer) for layer in head["layers"]] == \
        [{"mlp"}] * pcfg.n_layers
    back = baselines._merge_rep_head(shared, head)
    assert [p for p, _ in tree_leaves(back)] == [p for p, _ in
                                                 tree_leaves(ad)]
    for (_, x), (_, y) in zip(tree_leaves(back), tree_leaves(ad)):
        assert x is y


# ---------------------------------------------------------------------------
# answer_accuracy
# ---------------------------------------------------------------------------

def test_answer_accuracy_matches_reference(setup):
    """Same params, adapters (B non-zero) and examples: the logits at the
    answer positions agree and so does the accuracy, on examples whose
    answers are crafted from the reference's own greedy picks (every
    other example right where the pick is a one-byte character), so that
    it is neither 0 nor 1 and the two packages must pick alike."""
    jcfg, jm, jp, pcfg, pm, pp = setup
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    jad = jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)
    pad = bridge.adapters_from_jax(jad, device="cpu")
    jad = jax.tree.map(jnp.asarray, jad)
    examples = j_synth.gen_medical_dataset(np.random.default_rng(2), 24, 1)
    examples += j_synth.gen_log_dataset(np.random.default_rng(3), 24, 0)
    jtok, max_len, scale = JTokenizer(), 48, 2.0
    # the reference's greedy pick at each answer position (batches of 5,
    # so the last batch is ragged)
    from repro.data.tokenizer import pad_batch
    prompts = [jtok.encode(ex.prompt) for ex in examples]
    toks, _ = pad_batch(prompts, max_len)
    jlogits, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, adapters=jad,
                            lora_scale=scale)
    last = [min(len(p), max_len) - 1 for p in prompts]
    jl = np.asarray(jlogits)[np.arange(len(examples)), last]
    picks = jl.argmax(-1)
    crafted = []
    for i, (ex, pick) in enumerate(zip(examples, picks)):
        hit = i % 2 == 0 and pick < 128
        ans = chr(pick) if hit else chr(1 + (pick % 100)) + "x"
        crafted.append(synthetic.Example(ex.prompt, ans, ex.cls))
    want = sum(i % 2 == 0 and p < 128 for i, p in enumerate(picks)) / len(
        examples)
    assert 0 < want < 1
    ja = j_synth.answer_accuracy(jm, jcfg, jp, jad, crafted, jtok, max_len,
                                 scale, batch_size=5)
    pa = synthetic.answer_accuracy(pm, pcfg, pp, pad, crafted,
                                   ByteTokenizer(), max_len, scale,
                                   batch_size=5)
    assert ja == want
    assert pa == ja
    got = synthetic.answer_logits(pm, pp, pad, crafted, ByteTokenizer(),
                                  max_len, scale, batch_size=5)
    np.testing.assert_allclose(got.numpy(), jl, atol=LOSS_TOL, rtol=1e-5)
    # a prompt longer than max_len reads the last kept position
    long = [synthetic.Example("x" * 80, "y", 0)]
    got = synthetic.answer_logits(pm, pp, pad, long, ByteTokenizer(),
                                  max_len, scale)
    full, _ = pm.forward(pp, {"tokens": torch.as_tensor(
        pad_batch([jtok.encode(long[0].prompt)], max_len)[0])},
        adapters=pad, lora_scale=scale)
    torch.testing.assert_close(got[0], full[0, max_len - 1])
    assert synthetic.answer_accuracy(pm, pcfg, pp, pad, [], ByteTokenizer(),
                                     max_len, scale) == \
        j_synth.answer_accuracy(jm, jcfg, jp, jad, [], jtok, max_len, scale)


def test_missing_card_raises_for_the_baselines(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jcfg, jm, jp, pcfg, pm, pp = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.FedAvg(pm, pcfg, baselines.FedConfig(), pp)
    with pytest.raises(ValueError, match="cuda"):
        baselines.FedAvg(pm, pcfg, baselines.FedConfig(), pp, device="cpu",
                         paged_backend="cuda")

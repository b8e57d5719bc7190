"""The port's training slice against the reference package on the CPU.

Optimizers, the outer step, one LoRA train step (loss and every adapter
gradient against ``jax.value_and_grad``), three steps, the AdaFusion
objective, the data copies, checkpoints in both directions, and the whole
of Algorithm 1 (``FDLoRATrainer.fit``) against the reference trainer.
Everything runs in fp32 on ``tiny_dense`` from the same numpy inputs; the
base weights are the reference init, bridged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core import fdlora as j_fdlora
from repro.core.lora import init_adapters as j_init_adapters
from repro.core.outer_opt import make_outer_optimizer as j_outer_opt
from repro.core.outer_opt import outer_step as j_outer_step
from repro.data import partition as j_partition
from repro.data import synthetic as j_synth
from repro.data.pipeline import SFTBatcher as JBatcher
from repro.data.tokenizer import ByteTokenizer as JTokenizer
from repro.models.api import get_model
from repro.training import checkpoint as j_ckpt
from repro.training import optimizers as j_opt
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.core import fdlora
from repro_torch.core.dual_lora import dual_tree, merge
from repro_torch.core.lora import tree_leaves, tree_norm
from repro_torch.core.outer_opt import make_outer_optimizer, outer_step
from repro_torch.data import partition, synthetic
from repro_torch.data.pipeline import SFTBatcher
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.serving.registry import AdapterRegistry
from repro_torch.training import checkpoint, optimizers
from repro_torch.training.train_step import (lora_value_and_grad,
                                             make_eval_fn, make_fused_eval_fn,
                                             make_lora_train_step)

# fp32 on both sides from the same inputs: only summation order differs
# (losses are O(5), gradients and adapter leaves O(0.1))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


def leaf_tol(lr: float, steps: int) -> float:
    """Adapters after AdamW steps: Adam divides by sqrt(v) + eps, so a
    gradient element not far above eps carries its fp32 summation noise
    into an update of up to lr in size; 1e-2 of lr per step bounds it."""
    return 1e-2 * lr * steps


def _np(t):
    return np.asarray(t, np.float32)


def _to_torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _assert_trees_close(port, ref, atol, rtol=1e-4):
    """A port tree (dict of tensors) against a reference tree of the same
    dict layout (numpy/JAX leaves)."""
    got = dict(tree_leaves(port))
    want = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   _np(want[path]), atol=atol, rtol=rtol,
                                   err_msg=path)


def _assert_adapters_close(port, jtree, atol, rtol=1e-4):
    """Port adapters ({"layers": [...]}) against a reference tree stacked
    on the period axis."""
    _assert_trees_close(port, bridge.adapters_from_jax(
        jax.tree.map(np.asarray, jtree), device="cpu"), atol, rtol)


# ---------------------------------------------------------------------------
# optimizers and the outer step, on random trees
# ---------------------------------------------------------------------------

def _rand_tree(rng):
    return {"x": {"a": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": rng.standard_normal((3, 4)).astype(np.float32)},
            "y": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["adamw", "nesterov", "sgd"])
def test_optimizer_steps_match_reference(kind):
    rng = np.random.default_rng(0)
    params = _rand_tree(rng)
    grads = [_rand_tree(rng) for _ in range(3)]
    if kind == "adamw":
        jo = j_opt.adamw(lr=1e-2, weight_decay=0.1,
                         schedule=j_opt.cosine_schedule(1, 3))
        po = optimizers.adamw(lr=1e-2, weight_decay=0.1,
                              schedule=optimizers.cosine_schedule(1, 3))
    else:
        nest = kind == "nesterov"
        jo = j_opt.sgd(lr=0.1, momentum=0.5 if nest else 0.0, nesterov=nest)
        po = optimizers.sgd(lr=0.1, momentum=0.5 if nest else 0.0,
                            nesterov=nest)
    jp, pp = jax.tree.map(jnp.asarray, params), _to_torch_tree(params)
    js, ps = jo.init(jp), po.init(pp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        pu, ps = po.update(_to_torch_tree(g), ps, pp)
        _assert_trees_close(pu, ju, atol=1e-7)
        jp, pp = j_opt.apply_updates(jp, ju), optimizers.apply_updates(pp, pu)
    _assert_trees_close(pp, jp, atol=1e-6)


def test_tree_ops_match_reference():
    from repro.core import lora as j_lora
    from repro_torch.core import lora as p_lora
    rng = np.random.default_rng(9)
    ta, tb, tc = (_rand_tree(rng) for _ in range(3))
    ja, jb, jc = (jax.tree.map(jnp.asarray, t) for t in (ta, tb, tc))
    pa, pb, pc = (_to_torch_tree(t) for t in (ta, tb, tc))
    for name, args_j, args_p in (("tree_add", (ja, jb), (pa, pb)),
                                 ("tree_sub", (ja, jb), (pa, pb)),
                                 ("tree_scale", (ja, 0.3), (pa, 0.3)),
                                 ("tree_mean", ([ja, jb, jc],), ([pa, pb, pc],)),
                                 ("tree_zeros_like", (ja,), (pa,))):
        _assert_trees_close(getattr(p_lora, name)(*args_p),
                            getattr(j_lora, name)(*args_j), atol=1e-6)
    assert float(p_lora.tree_dot(pa, pb)) == pytest.approx(
        float(j_lora.tree_dot(ja, jb)), rel=1e-5)
    assert float(p_lora.tree_norm(pa)) == pytest.approx(
        float(j_lora.tree_norm(ja)), rel=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _rand_tree(np.random.default_rng(1))
    out = optimizers.clip_by_global_norm(_to_torch_tree(g), max_norm)
    _assert_trees_close(out, j_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm), atol=1e-7)
    assert float(tree_norm(out)) <= max_norm * (1 + 1e-6)


def test_cosine_schedule_matches_reference():
    jf, pf = j_opt.cosine_schedule(3, 10), optimizers.cosine_schedule(3, 10)
    for c in range(0, 13):
        assert pf(c) == pytest.approx(float(jf(jnp.asarray(c))), abs=1e-7)


def test_outer_step_matches_reference():
    rng = np.random.default_rng(2)
    theta = _rand_tree(rng)
    jt, pt = jax.tree.map(jnp.asarray, theta), _to_torch_tree(theta)
    jo, po = j_outer_opt("nesterov", 0.7, 0.5), make_outer_optimizer(
        "nesterov", 0.7, 0.5)
    js, ps = jo.init(jt), po.init(pt)
    for _ in range(2):
        clients = [_rand_tree(rng) for _ in range(3)]
        jt, js, jd = j_outer_step(jo, jt, js, [jax.tree.map(jnp.asarray, c)
                                               for c in clients])
        pt, ps, pd = outer_step(po, pt, ps, [_to_torch_tree(c)
                                             for c in clients])
        _assert_trees_close(pd, jd, atol=1e-6)
        _assert_trees_close(pt, jt, atol=1e-6)


# ---------------------------------------------------------------------------
# train steps on tiny_dense
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, pcfg, pm, pp


def _adapters(jcfg, seed):
    """A numpy-seeded reference adapter tree with a NON-ZERO B, so that
    neither factor's gradient can hide."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def _batch(seed, B=3, S=24, vocab=300):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.int32)
    return {"tokens": toks, "loss_mask": mask}


def test_train_step_loss_and_gradients_match_reference(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad = _adapters(jcfg, 1)
    batch = _batch(2)
    loss_fn = j_ts.make_lora_loss_fn(jm, jcfg)
    (jl, jmet), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, ad), jp,
        jax.tree.map(jnp.asarray, batch))
    loss, met, grads = lora_value_and_grad(pm, pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]))
    assert float(met["tokens"]) == float(jmet["tokens"])
    _assert_adapters_close(grads, jg, atol=GRAD_TOL)
    # the base weights get no gradient
    assert all(not t.requires_grad for _, t in tree_leaves(pp))


def test_three_train_steps_match_reference(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad = _adapters(jcfg, 3)
    jo = j_opt.adamw(lr=1e-3, schedule=j_opt.cosine_schedule(1, 3))
    po = optimizers.adamw(lr=1e-3, schedule=optimizers.cosine_schedule(1, 3))
    jstep = jax.jit(j_ts.make_lora_train_step(jm, jcfg, jo))
    pstep = make_lora_train_step(pm, pcfg, po)
    jad = jax.tree.map(jnp.asarray, ad)
    pad = bridge.adapters_from_jax(ad, device="cpu")
    js, ps = jo.init(jad), po.init(pad)
    for i in range(3):
        batch = _batch(10 + i)
        jad, js, jm_ = jstep(jp, jad, js, jax.tree.map(jnp.asarray, batch))
        pad, ps, pm_ = pstep(pp, pad, ps, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        assert float(pm_["loss"]) == pytest.approx(float(jm_["loss"]),
                                                   abs=LOSS_TOL)
    _assert_adapters_close(pad, jad, atol=leaf_tol(1e-3, 3))


def test_eval_fn_matches_reference(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad, batch = _adapters(jcfg, 8), _batch(9)
    jmet = j_ts.make_eval_fn(jm, jcfg)(jp, jax.tree.map(jnp.asarray, ad),
                                       jax.tree.map(jnp.asarray, batch))
    pmet = make_eval_fn(pm, pcfg)(pp, bridge.adapters_from_jax(ad, device="cpu"),
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                abs=LOSS_TOL)
    assert float(pmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]))
    assert float(pmet["tokens"]) == float(jmet["tokens"])


def test_fused_eval_matches_reference(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad_p, ad_s = _adapters(jcfg, 4), _adapters(jcfg, 5)
    batch = _batch(6)
    w = np.asarray([0.7, 0.4], np.float32)
    jl, _ = j_ts.make_fused_eval_fn(jm, jcfg)(
        jp, jax.tree.map(jnp.asarray, ad_p), jax.tree.map(jnp.asarray, ad_s),
        jnp.asarray(w), jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp, ts = bridge.adapters_from_jax(ad_p, device="cpu"), bridge.adapters_from_jax(ad_s, device="cpu")
    loss, _ = make_fused_eval_fn(pm, pcfg)(pp, tp, ts, w, tbatch)
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    # the unmerged dual tree (what the "cuda" path hands the dual kernel)
    # gives the same forward on the plain path
    lm = pm.forward(pp, tbatch, merge(tp, ts, w), 2.0)[0]
    ld = pm.forward(pp, tbatch, dual_tree(tp, ts, w), 2.0)[0]
    torch.testing.assert_close(ld, lm, atol=1e-5, rtol=1e-5)
    assert isinstance(L.lora_pair(dual_tree(tp, ts, w)["layers"][0]["mixer"],
                                  "wq"), L.DualPair)


def test_cuda_backend_refused_on_cpu_for_training(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = fdlora.FDLoRAConfig(n_clients=1)
    with pytest.raises(ValueError, match="cuda"):
        fdlora.FDLoRATrainer(pm, pcfg, fed, pp, device="cpu",
                             paged_backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        make_fused_eval_fn(pm, pcfg, paged_backend="cuda")
    step = make_lora_train_step(pm, pcfg, optimizers.adamw(),
                                paged_backend="cuda")
    ad = bridge.adapters_from_jax(_adapters(jcfg, 0), device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        step(pp, ad, optimizers.adamw().init(ad),
             {k: torch.from_numpy(v) for k, v in _batch(0).items()})


def test_missing_card_raises_for_training_entry_points(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jcfg, jm, jp, pcfg, pm, pp = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fdlora.FDLoRATrainer(pm, pcfg, fdlora.FDLoRAConfig(), pp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fdlora.init_adapters(pcfg)
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

def test_data_copies_make_the_same_batches():
    for make_j, make_p in ((j_synth.gen_log_dataset, synthetic.gen_log_dataset),
                           (j_synth.gen_medical_dataset,
                            synthetic.gen_medical_dataset)):
        ej = make_j(np.random.default_rng(0), 20, 1)
        ep = make_p(np.random.default_rng(0), 20, 1)
        assert [(e.prompt, e.answer, e.cls) for e in ej] == \
            [(e.prompt, e.answer, e.cls) for e in ep]
    jb = JBatcher(ej, JTokenizer(), 96, 4, seed=3)
    pb = SFTBatcher(ep, ByteTokenizer(), 96, 4, seed=3)
    for _ in range(3):
        bj, bp = jb.sample(), pb.sample()
        assert bj.keys() == bp.keys()
        for k in bj:
            np.testing.assert_array_equal(bj[k], bp[k])
    for bj, bp in zip(jb.epoch(), pb.epoch()):
        np.testing.assert_array_equal(bj["tokens"], bp["tokens"])
    np.testing.assert_array_equal(jb.few_shot(5)["loss_mask"],
                                  pb.few_shot(5)["loss_mask"])
    pool = (j_synth.gen_log_dataset(np.random.default_rng(1), 30, 0)
            + j_synth.gen_log_dataset(np.random.default_rng(2), 30, 2))
    pj = j_partition.dirichlet_partition(pool, 3, 0.5,
                                         np.random.default_rng(4))
    pp = partition.dirichlet_partition(pool, 3, 0.5, np.random.default_rng(4))
    assert [[e.prompt for e in c] for c in pj] == \
        [[e.prompt for e in c] for c in pp]


def test_checkpoints_cross_between_the_packages(setup, tmp_path):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad = _adapters(jcfg, 7)
    # written by the reference, read by the port
    j_ckpt.save_checkpoint(str(tmp_path / "j.npz"), ad, {"steps": 3})
    got = checkpoint.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    _assert_adapters_close(got, ad, atol=0.0, rtol=0.0)
    # bf16 base weights too
    jpb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    j_ckpt.save_checkpoint(str(tmp_path / "p.npz"), jpb)
    gotp = checkpoint.load_checkpoint(str(tmp_path / "p.npz"), device="cpu")
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jpb), device="cpu")
    assert gotp["layers"][1]["mixer"]["wq"].dtype == torch.bfloat16
    for (pa, a), (pb, b) in zip(tree_leaves(gotp), tree_leaves(want)):
        assert pa == pb and torch.equal(a, b)
    # written by the port, read by the reference
    port_ad = bridge.adapters_from_jax(ad, device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "t.npz"), port_ad,
                               {"arch": "tiny"})
    back = j_ckpt.load_checkpoint(str(tmp_path / "t.npz"))
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(_np(x), _np(y)),
                 back, ad)


def test_train_cli_runs_on_cpu_and_writes_a_checkpoint(tmp_path):
    from repro_torch.launch.train import main
    path = str(tmp_path / "ad.npz")
    ad = main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
               "--seq", "128", "--ckpt", path])
    back = checkpoint.load_checkpoint(path, device="cpu")
    for (pa, a), (pb, b) in zip(tree_leaves(back), tree_leaves(ad)):
        assert pa == pb and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the slice as a whole: Algorithm 1
# ---------------------------------------------------------------------------

def test_fdlora_fit_matches_reference_trainer(setup, monkeypatch):
    """Both trainers start from the same adapters (the port's initial
    adapters are the reference's, bridged) and see the same batches: round
    losses, θ_s, the fusion weights and the fused-eval loss agree."""
    jcfg, jm, jp, pcfg, pm, pp = setup
    fed = fdlora.FDLoRAConfig(n_clients=2, rounds=2, inner_steps=2,
                              sync_every=1, stage1_steps=2, fusion_steps=1,
                              few_shot_k=4)
    jfed = j_fdlora.FDLoRAConfig(**vars(fed))

    def batchers(cls, tok):
        rng = np.random.default_rng(0)
        return [cls(j_synth.gen_log_dataset(rng, 16, i), tok, 96, 3, seed=i)
                for i in range(fed.n_clients)]

    def bridged_init(cfg, seed, device):
        ad = j_init_adapters(jax.random.PRNGKey(seed), jcfg)
        return bridge.adapters_from_jax(jax.tree.map(np.asarray, ad), device)
    monkeypatch.setattr(fdlora, "init_adapters", bridged_init)

    jtr = j_fdlora.FDLoRATrainer(jm, jcfg, jfed, jp)
    jclients = jtr.fit(batchers(JBatcher, JTokenizer()))
    ptr = fdlora.FDLoRATrainer(pm, pcfg, fed, pp, device="cpu")
    pb = batchers(SFTBatcher, ByteTokenizer())
    pclients = ptr.fit(pb)

    assert [h["round"] for h in ptr.history] == [1, 2]
    np.testing.assert_allclose([h["loss"] for h in ptr.history],
                               [h["loss"] for h in jtr.history],
                               atol=LOSS_TOL)
    # every leaf has been through at most stage1_steps + rounds *
    # inner_steps AdamW steps
    tol = leaf_tol(fed.inner_lr, fed.stage1_steps
                   + fed.rounds * fed.inner_steps)
    _assert_adapters_close(ptr.theta_s, jtr.theta_s, atol=tol)
    for i, (jc, pc) in enumerate(zip(jclients, pclients)):
        _assert_adapters_close(pc.personalized, jc.personalized, atol=tol)
        np.testing.assert_allclose(pc.fusion_weights, jc.fusion_weights,
                                   atol=1e-6)
        q = pb[i].few_shot(fed.few_shot_k)
        jl, _ = jtr._fused_eval(jp, jc.personalized, jtr.theta_s,
                                jnp.asarray(jc.fusion_weights),
                                jax.tree.map(jnp.asarray, q))
        assert ptr.fused_eval_loss(pc, pc.fusion_weights, q) == \
            pytest.approx(float(jl), abs=LOSS_TOL)
        assert pc.comm_bytes_up == jc.comm_bytes_up > 0
    # publish closes the loop into the serving slice's registry
    reg = AdapterRegistry(pcfg, capacity=2, device="cpu")
    slots = ptr.publish(reg, pclients)
    fused = ptr.fused_adapters(pclients[1])
    bank = reg.bank()["layers"][0]["mlp"]["w_up"]["a"]
    torch.testing.assert_close(bank[slots["client1"]],
                               fused["layers"][0]["mlp"]["w_up"]["a"])
    assert reg.version("client0") == 1

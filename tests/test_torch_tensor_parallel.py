"""Tensor parallelism over the mesh's ``"model"`` axis
(``models/tensor_parallel.py``) against the reference and the port's
unsplit paths, on ``tiny_dense`` in fp32 (4 heads, 2 kv heads, d_ff 128
and vocabulary 300, each divisible by 2).

* ``local_config`` and the refusals of what is not split (counts that do
  not divide, the expert and SSM-head counts included; full
  fine-tuning), and the dry run's serving steps at the model axis;
* the vocabulary-parallel embedding, cross entropy and argmax on 2, 3
  and 4 ranks simulated by threads, against the plain ones, with ties in
  the argmax across the vocabulary blocks;
* on 2 gloo ranks (one spawn, ``torch_tp_ranks.world2``): the forward's
  logits against the reference's ``forward``; the LoRA loss and every
  adapter gradient against ``jax.value_and_grad``; one SGD step whose
  clip binds against the reference's train step (an SGD update is
  proportional to the clipped gradient, so a per-rank norm shows), and on
  4 ranks the same step on a (1, 2, 2) mesh, each data rank on half the
  rows;
* the FDLoRA round at (1, 1, 2) (world 2) and at (2, 1, 2) and
  (1, 2, 2) (world 4): two clients in fp32 within ``leaf_tol`` of the
  port's meshless round, four clients with bf16 pseudo-gradients within
  the reference's tolerance of the reference's round
  (``tests/test_torch_mesh_round.py``'s fixtures and checks);
* replicated leaves bitwise across the model group, the collective log
  equal in count and bytes to the dry run's walk of the same round, and
  the dry run's per-rank argument bytes equal to the local shards'.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from conftest import tiny_dense
from repro.training import optimizers as j_opt
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import (adapter_specs, init_adapters,
                                   tree_leaves, tree_norm)
from repro_torch.core.partition import entry_axes, spec_map
from repro_torch.federated import distributed
from repro_torch.federated.mesh_job import Case
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from repro_torch.training import optimizers
from repro_torch.training.train_step import (cross_entropy,
                                             make_full_train_step)
from test_torch_mesh_round import (B, K, N, N4, ROUNDS, S, _held_to,  # noqa
                                   _held_to_reference, _job, meshless,
                                   one_torch_thread, reference, setup)

LOGIT_TOL = 1e-4         # as tests/test_torch_model.py
LOSS_TOL = 1e-5          # as tests/test_torch_training.py
GRAD_TOL = 1e-5
SGD_LR, CLIP = 0.5, 0.5  # the clip binds: the gradient's norm is about 3

TP2 = [Case(pod=1, data=1, model=2, sync=True)]
TP4 = [Case(pod=2, data=1, model=2, sync=True),
       Case(pod=1, data=2, model=2, sync=True)]
TP2_4 = [Case(pod=1, data=1, model=2, compress="bf16", sync=True)]
TP4_4 = [Case(pod=p, data=d, model=2, compress="bf16", sync=True)
         for p, d in ((2, 1), (1, 2))]


def _cfg():
    return bridge.config_from_jax(tiny_dense(dtype="float32",
                                             param_dtype="float32"))


# ---------------------------------------------------------------------------
# local_config and the refusals
# ---------------------------------------------------------------------------

def test_local_config_is_the_local_shard():
    cfg = _cfg()
    local = tpl.local_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.vocab_size,
            local.resolved_head_dim) == (2, 1, 64, 150, 16)
    assert tpl.local_config(cfg, 1) == cfg.with_overrides(head_dim=16)
    # the shard shapes of every parameter and adapter leaf, at each rank
    params = Model(cfg, "cpu").init(0)
    adapters = init_adapters(cfg, device="cpu")
    want_p = Model(local, "meta").init()
    want_a = init_adapters(local, device="meta")
    for rank in (0, 1):
        mesh = dryrun.RankMesh((1, 1, 2))
        mesh.get_coordinate = lambda r=rank: (0, 0, r)
        for tree, specs, want in ((params, param_specs(cfg), want_p),
                                  (adapters, adapter_specs(cfg), want_a)):
            got = distributed.local_shard(tree, specs, mesh)
            assert ([(p, t.shape) for p, t in tree_leaves(got)]
                    == [(p, t.shape) for p, t in tree_leaves(want)])


@pytest.mark.parametrize("arch,size,match", [
    ("gemma-2b", 2, "n_kv_heads 1 does not divide"),
    ("yi-6b", 16, "n_kv_heads 4 does not divide"),
    ("starcoder2-15b", 16, "n_kv_heads 4 does not divide"),
    ("llama2-7b", 3, "n_heads 32 does not divide"),
    ("dbrx-132b-3-experts", 2, "n_experts 3 does not divide"),
    ("mamba2-2.7b", 32, "ssm_n_heads 80 does not divide"),
    ("jamba-v0.1-52b", 16, "n_kv_heads 8 does not divide"),
    ("mamba2-smoke-4-heads", 8, "ssm_n_heads 4 does not divide"),
    ("internvl2-26b", 16, "n_kv_heads 8 does not divide"),
    ("whisper-small", 8, "n_heads 12 does not divide"),
])
def test_what_is_not_split_is_refused(arch, size, match):
    cfg = {"dbrx-132b-3-experts": lambda: get_config(
        "dbrx-132b").with_overrides(n_experts=3),
        "mamba2-smoke-4-heads": lambda: get_config(
            "mamba2-2.7b", smoke=True).with_overrides(ssm_head_dim=64),
    }.get(arch, lambda: get_config(arch))()
    with pytest.raises(ValueError, match=match):
        tpl.check_model_axis(cfg, size)
    with pytest.raises(ValueError, match=match):
        dryrun.dry_run(cfg, "train", 2 * size, 16, mesh=(1, 1, size))


def test_full_training_and_serving_over_the_model_axis_are_refused():
    """Full fine-tuning takes no model group; serving's dry-run steps walk
    one rank at the model axis (they were refused before the slice that
    serves over a mesh): per layer two activation sums, the embedding's,
    and the greedy sample's one reduce."""
    cfg = _cfg()
    model = Model(cfg, "cpu")
    group = tpl.ModelGroup(2, 0, lambda t, op="sum": t)
    with pytest.raises(TypeError, match="tp"):   # it takes no model group
        make_full_train_step(model, cfg, optimizers.adamw(), tp=group)
    for step in ("prefill", "decode"):
        res = dryrun.dry_run(cfg.with_overrides(paged_backend="cuda"), step,
                             2, 16, mesh=(1, 1, 2))
        assert [(c["axis"], c["group"]) for c in res["collectives"]] == (
            [("model", 2)] * (2 * cfg.n_layers + 2))
    for arch in ("llama2-7b", "olmo-1b"):     # --mesh 2,16,16's archs
        tpl.check_model_axis(get_config(arch), 16)


# ---------------------------------------------------------------------------
# the vocabulary-parallel functions on ranks simulated by threads
# ---------------------------------------------------------------------------

class ThreadGroup:
    """``size`` ranks as threads of this process; each reduce stacks the
    ranks' tensors and reduces them in one order, so every rank gets the
    same bits, as a collective gives them."""

    def __init__(self, size):
        self.size, self.slots = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def member(self, rank):
        def reduce(t, op="sum"):
            self.slots[rank] = t.clone()
            self.barrier.wait()
            v = torch.stack(self.slots)
            out = {"sum": v.sum(0), "max": v.amax(0), "min": v.amin(0)}[op]
            self.barrier.wait()
            return t.copy_(out)
        return tpl.ModelGroup(self.size, rank, reduce)

    def run(self, fn):
        out, errs = [None] * self.size, []

        def work(r):
            try:
                out[r] = fn(self.member(r))
            except BaseException as e:      # noqa: BLE001 (re-raised)
                errs.append(e)
                self.barrier.abort()
        ts = [threading.Thread(target=work, args=(r,))
              for r in range(self.size)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        if errs:
            raise errs[0]
        return out


@pytest.mark.parametrize("size", [2, 3, 4])
def test_vocab_parallel_embed_and_cross_entropy_match_plain(size):
    cfg = _cfg()
    V = cfg.vocab_size
    rng = np.random.default_rng(size)
    Bq, Sq = 3, 12
    tokens = torch.from_numpy(rng.integers(0, V, (Bq, Sq)))
    mask = torch.from_numpy((rng.random((Bq, Sq)) < 0.7).astype(np.int32))
    batch = {"tokens": tokens, "loss_mask": mask}
    # logits on a coarse grid (many ties), and rows whose maximum appears
    # in every vocabulary block: the first index must win
    logits = torch.from_numpy(rng.integers(-3, 4, (Bq, Sq, V))
                              .astype(np.float32) / 2)
    w = V // size
    logits[0, :, :] = -2.0
    logits[0, :, [w * r + 5 for r in range(size)]] = 3.0
    logits[1, 2, [w * r + 1 for r in range(size)]] = 9.0
    tokens[0, 1:] = w * (size - 1) + 5       # a tied max, not the first
    tokens[1, 3] = 1                         # the first of its ties
    mask[1, 3] = 1
    embed = torch.from_numpy(rng.standard_normal((V, 8)).astype(np.float32))

    def plain():
        lg = logits.clone().requires_grad_(True)
        loss, m = cross_entropy(cfg, lg, batch)
        (g,) = torch.autograd.grad(loss, lg)
        return loss.detach(), m, g
    want_loss, want_m, want_g = plain()
    assert 0 < float(want_m["accuracy"])

    def rank(tp):
        lg = logits[..., tp.rank * w:(tp.rank + 1) * w].clone()
        lg.requires_grad_(True)
        loss, m = cross_entropy(cfg, lg, batch, tp=tp)
        (g,) = torch.autograd.grad(loss, lg)
        loss = loss.detach()
        x = tpl.vocab_parallel_embed(embed[tp.rank * w:(tp.rank + 1) * w],
                                     tokens, tp)
        return loss, m, g, x
    out = ThreadGroup(size).run(rank)
    for loss, m, _, x in out:
        assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_TOL)
        assert float(m["accuracy"]) == float(want_m["accuracy"])
        assert torch.equal(x, embed[tokens])
    assert len({float(o[0]) for o in out}) == 1
    got_g = torch.cat([o[2] for o in out], -1)
    torch.testing.assert_close(got_g, want_g, atol=1e-7, rtol=1e-5)
    # the argmax on its own: ties across the blocks go to the first index
    gmax = torch.amax(logits, -1)
    top = ThreadGroup(size).run(lambda tp: tpl.vocab_parallel_argmax(
        logits[..., tp.rank * w:(tp.rank + 1) * w], gmax, tp))
    for t in top:
        assert torch.equal(t, torch.argmax(logits, -1))


# ---------------------------------------------------------------------------
# two and four gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs(setup):
    """The tiny model's base (the reference's init, bridged), adapters
    with a non-zero B and a batch, on both sides."""
    jcfg, jm, jp = setup[:3]
    rng = np.random.default_rng(7)
    from repro.core.lora import init_adapters as j_init_adapters
    ad = jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        j_init_adapters(jax.random.PRNGKey(2), jcfg))
    toks = rng.integers(0, jcfg.vocab_size, (3, 20)).astype(np.int32)
    batch = {"tokens": toks,
             "loss_mask": (rng.random((3, 20)) < 0.7).astype(np.int32)}
    return ad, batch


@pytest.fixture(scope="module")
def world2(setup, step_inputs):
    job, job4 = setup[5], setup[6]
    ad, batch = step_inputs
    step_args = {"cfg": job.cfg, "params": job.params,
                 "adapters": bridge.adapters_from_jax(ad, device="cpu"),
                 "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                 "lr": SGD_LR, "clip": CLIP}
    ranks = spawn(torch_tp_ranks.world2, 2,
                  [_job(job, TP2), _job(job4, TP2_4)], step_args,
                  device="cpu")
    return ([[r for res in rk["rounds"] for r in res] for rk in ranks],
            sorted((rk["step"] for rk in ranks),
                   key=lambda s: s["coord"]["model"]))


@pytest.fixture(scope="module")
def step4_batch(setup):
    """A 4-row batch, 2 rows a data rank of the ``(1, 2, 2)`` step."""
    rng = np.random.default_rng(8)
    toks = rng.integers(0, setup[0].vocab_size, (4, 20)).astype(np.int32)
    return {"tokens": toks,
            "loss_mask": (rng.random((4, 20)) < 0.7).astype(np.int32)}


@pytest.fixture(scope="module")
def world4(setup, step_inputs, step4_batch):
    job = setup[5]
    step_args = {"cfg": job.cfg, "params": job.params,
                 "adapters": bridge.adapters_from_jax(step_inputs[0],
                                                      device="cpu"),
                 "batch": {k: torch.from_numpy(v)
                           for k, v in step4_batch.items()},
                 "lr": SGD_LR, "clip": CLIP}
    ranks = spawn(torch_tp_ranks.world4, 4,
                  [_job(job, TP4), _job(setup[6], TP4_4)], step_args,
                  device="cpu")
    return ([[r for res in rk["rounds"] for r in res] for rk in ranks],
            sorted((rk["step"] for rk in ranks),
                   key=lambda s: (s["coord"]["data"], s["coord"]["model"])))


def _gather(spec_tree, shards):
    """The whole tree from its model shards (in model-coordinate order):
    a leaf split over "model" joined (``tensor_parallel.join_leaf``), a
    replicated one held bitwise equal on every rank."""
    def join(spec, *leaves):
        if any("model" in entry_axes(e) for e in spec):
            return tpl.join_leaf(spec, list(leaves))
        for x in leaves[1:]:
            assert torch.equal(x, leaves[0])
        return leaves[0]
    return spec_map(join, spec_tree, *shards)


def _whole(results, case, clients):
    """Per (pod, data) coordinate, one result with θ_s' and the state
    gathered over the model group; the model group's losses, θ digests
    of the replicated leaves and outer states agree."""
    specs = adapter_specs(_cfg())
    stacked = distributed.client_stacked_specs(specs)
    mine = [r for res in results for r in res
            if (r["case"]["pod"], r["case"]["data"], r["case"]["model"],
                r["case"]["compress"]) == (case.pod, case.data, case.model,
                                           case.compress)
            and r["clients"] == clients]
    groups = {}
    for r in mine:
        groups.setdefault((r["coord"]["pod"], r["coord"]["data"]),
                          []).append(r)
    out = []
    for (pod, _), grp in sorted(groups.items()):
        grp.sort(key=lambda r: r["coord"]["model"])
        assert [r["coord"]["model"] for r in grp] == [0, 1]
        assert grp[0]["loss"] == grp[1]["loss"]
        st = grp[0]["state"]
        out.append({
            "coord": {"pod": pod}, "loss": grp[0]["loss"],
            "theta": _gather(specs, [r["theta"] for r in grp]),
            "state": {
                "personalized": _gather(
                    stacked, [r["state"]["personalized"] for r in grp]),
                "inner_opt": {"count": st["inner_opt"]["count"]},
                "outer_opt": _gather({"v": specs}, [r["state"]["outer_opt"]
                                                     for r in grp])}})
    return out


def test_forward_logits_match_reference(setup, step_inputs, world2):
    jcfg, jm, jp = setup[:3]
    ad, batch = step_inputs
    want, _ = jm.forward(jp, jax.tree.map(jnp.asarray, batch),
                         adapters=jax.tree.map(jnp.asarray, ad),
                         lora_scale=jcfg.lora_alpha / jcfg.lora_rank)
    steps = world2[1]
    assert [s["logits"].shape[-1] for s in steps] == [150, 150]
    got = torch.cat([s["logits"] for s in steps], -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=1e-4)


def test_train_step_loss_and_gradients_match_reference(setup, step_inputs,
                                                       world2):
    jcfg, jm, jp = setup[:3]
    ad, batch = step_inputs
    jad, jb = jax.tree.map(jnp.asarray, ad), jax.tree.map(jnp.asarray, batch)
    (jl, jmet), jg = jax.value_and_grad(j_ts.make_lora_loss_fn(jm, jcfg),
                                        has_aux=True)(jad, jp, jb)
    steps = world2[1]
    for s in steps:
        assert float(s["loss"]) == pytest.approx(float(jl), abs=LOSS_TOL)
        assert float(s["metrics"]["accuracy"]) == pytest.approx(
            float(jmet["accuracy"]))
    assert float(steps[0]["loss"]) == float(steps[1]["loss"])
    grads = _gather(adapter_specs(_cfg()), [s["grads"] for s in steps])
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, jg), "cpu")
    for (path, g), (_, w) in zip(tree_leaves(grads), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=path)
    # the clip's norm is the whole gradient's, on both ranks
    for s in steps:
        assert float(s["norm"]) == pytest.approx(float(tree_norm(want)),
                                                 rel=1e-5)


def test_a_step_whose_clip_binds_matches_reference(setup, step_inputs,
                                                   world2):
    jcfg, jm, jp = setup[:3]
    ad, batch = step_inputs
    steps = world2[1]
    assert float(steps[0]["norm"]) > 2 * CLIP      # the clip binds
    jo = j_opt.sgd(SGD_LR)
    jad = jax.tree.map(jnp.asarray, ad)
    want, _, _ = j_ts.make_lora_train_step(jm, jcfg, jo, clip_norm=CLIP)(
        jp, jad, jo.init(jad), jax.tree.map(jnp.asarray, batch))
    got = _gather(adapter_specs(_cfg()), [s["stepped"] for s in steps])
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, want), "cpu")
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=SGD_LR * GRAD_TOL, rtol=1e-5,
                                   err_msg=path)


def test_a_data_by_model_step_whose_clip_binds_matches_reference(
        setup, step_inputs, step4_batch, world4):
    """``make_lora_train_step(tp=, reduce_data=)`` on a (1, 2, 2) mesh:
    the global token mean over both data ranks' rows, the replicated
    leaves' partial gradients summed over the model group, the clip by
    the whole gradient's norm; the loss and the stepped adapters against
    the reference's step on the whole batch, and the step's collectives
    equal to the dry run's walk of the same step."""
    jcfg, jm, jp = setup[:3]
    jad = jax.tree.map(jnp.asarray, step_inputs[0])
    jb = jax.tree.map(jnp.asarray, step4_batch)
    (jl, _), jg = jax.value_and_grad(j_ts.make_lora_loss_fn(jm, jcfg),
                                     has_aux=True)(jad, jp, jb)
    jg = bridge.adapters_from_jax(jax.tree.map(np.asarray, jg), "cpu")
    assert float(tree_norm(jg)) > 2 * CLIP          # the clip binds
    jo = j_opt.sgd(SGD_LR)
    want, _, _ = j_ts.make_lora_train_step(jm, jcfg, jo, clip_norm=CLIP)(
        jp, jad, jo.init(jad), jb)
    want = bridge.adapters_from_jax(jax.tree.map(np.asarray, want), "cpu")
    steps = world4[1]
    assert [(s["coord"]["data"], s["coord"]["model"]) for s in steps] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    losses = [float(s["metrics"]["loss"]) for s in steps]
    assert losses == [losses[0]] * 4
    assert losses[0] == pytest.approx(float(jl), abs=LOSS_TOL)
    specs = adapter_specs(_cfg())
    got = [_gather(specs, [s["stepped"] for s in steps[2 * d:2 * d + 2]])
           for d in (0, 1)]
    for (path, g), (_, g1), (_, w) in zip(tree_leaves(got[0]),
                                          tree_leaves(got[1]),
                                          tree_leaves(want)):
        assert torch.equal(g, g1), path          # both data ranks agree
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=SGD_LR * GRAD_TOL, rtol=1e-5,
                                   err_msg=path)
    dry = dryrun.dry_run(_cfg().with_overrides(paged_backend="cuda"),
                         "train", 4, 20, mesh=(1, 2, 2))
    for s in steps:
        assert _by_axis(s["collectives"]) == _by_axis(dry["collectives"])


@pytest.mark.parametrize("grid,case", [("world2", TP2[0]), ("world4", TP4[0]),
                                       ("world4", TP4[1])],
                         ids=["1x1x2", "2x1x2", "1x2x2"])
def test_fp32_round_matches_meshless(request, meshless, grid, case):
    got = request.getfixturevalue(grid)
    results = got[0]
    ref = meshless[("none", True)]
    whole = _whole(results, case, N)
    assert len(whole) == case.pod * case.data
    _held_to(whole, case, N, list(zip([ref["theta"]] * ROUNDS, ref["loss"])),
             lambda i: distributed.client_slice(
                 ref["state"]["personalized"], i))


@pytest.mark.parametrize("grid,case", [("world2", TP2_4[0]),
                                       ("world4", TP4_4[0]),
                                       ("world4", TP4_4[1])],
                         ids=["1x1x2", "2x1x2", "1x2x2"])
def test_bf16_round_matches_reference(request, reference, grid, case):
    got = request.getfixturevalue(grid)
    results = got[0]
    _held_to_reference(_whole(results, case, N4), case, reference)


@pytest.mark.parametrize("grid", ["world2", "world4"])
def test_replicated_leaves_are_bitwise_equal_across_the_model_group(
        request, grid):
    got = request.getfixturevalue(grid)
    results = got[0]
    for case in TP2 + TP2_4 if grid == "world2" else TP4 + TP4_4:
        clients = N4 if case.compress == "bf16" else N
        for r in _whole(results, case, clients):     # _gather holds them
            assert np.isfinite(r["loss"]).all()
    if grid == "world2":
        steps = got[1]
        _gather(adapter_specs(_cfg()), [s["grads"] for s in steps])
        _gather(adapter_specs(_cfg()), [s["stepped"] for s in steps])


def _by_axis(log):
    out = {}
    for c in log:
        key = (c["axis"], c["group"])
        n, b = out.get(key, (0, 0))
        out[key] = (n + 1, b + c["bytes"])
    return out


@pytest.mark.parametrize("grid,case", [("world2", TP2[0]), ("world4", TP4[0]),
                                       ("world4", TP4[1])],
                         ids=["1x1x2", "2x1x2", "1x2x2"])
def test_collective_log_equals_the_dry_run(request, grid, case):
    got = request.getfixturevalue(grid)
    results = got[0]
    cfg = _cfg()
    dry = dryrun.dry_run(cfg.with_overrides(paged_backend="cuda"),
                         "fdlora_round", N * B, S,
                         mesh=(case.pod, case.data, case.model),
                         n_clients=N, K=K)
    want = _by_axis(dry["collectives"])
    # per layer, client and step: 2 sums forward, 2 of gradients backward
    # (the first layer's attention input has none), the embedding's and
    # the unembedding's, each (B / data, S, d) fp32; 3 of the cross
    # entropy; per step one of the clients' replicated leaves and norms
    per_client = 4 * cfg.n_layers + 1 + 3
    assert want[("model", 2)][0] == K * (per_client * N // case.pod + 1)
    for res in results:
        for r in res:
            if (r["case"]["pod"], r["case"]["data"], r["clients"]) != (
                    case.pod, case.data, N) or r["case"]["model"] != 2:
                continue
            for log in r["collectives"]:
                assert _by_axis(log) == want
    # the train step's log on two ranks: one step of the gradient
    if grid == "world2":
        for s in got[1]:
            assert len(s["collectives"]) == per_client + 1


@pytest.mark.parametrize("step", ["train", "fdlora_round"])
def test_dry_run_argument_bytes_are_the_local_shards(step):
    cfg = _cfg().with_overrides(paged_backend="cuda")
    mesh = dryrun.RankMesh((1, 1, 2))
    res = dryrun.dry_run(cfg, step, 4, S, mesh=(1, 1, 2))
    params = distributed.local_shard(Model(cfg, "cpu").init(0),
                                     param_specs(cfg), mesh)
    adapters = distributed.local_shard(init_adapters(cfg, device="cpu"),
                                       adapter_specs(cfg), mesh)
    opt = optimizers.adamw()
    tokens = torch.zeros(4, S, dtype=torch.int32)
    if step == "train":
        state, inputs = opt.init(adapters), [tokens, tokens]
    else:
        from repro_torch.core.outer_opt import make_outer_optimizer
        state = {"inner_opt": distributed.stack_clients(
            [opt.init(adapters)] * 2),
            "outer_opt": make_outer_optimizer("nesterov").init(adapters)}
        inputs = [torch.zeros(2, 3, 2, S, dtype=torch.int32)] * 2
    want = sum(t.numel() * t.element_size() for tree in (params, adapters,
                                                          state, inputs)
               for _, t in tree_leaves(tree) if isinstance(t, torch.Tensor))
    assert res["memory"]["argument_bytes"] == want
    assert res["roofline"]["chips"] == 2
    assert res["roofline"]["n_collectives"] == len(res["collectives"]) > 0


"""The SSM and hybrid families over a ``("pod", "data", "model")`` mesh
against the reference and the port's meshless runs, on mamba2-smoke and
jamba-smoke in fp32 (weights from the reference init, bridged; adapters,
batches and requests numpy-seeded), with one spawn of 2 gloo ranks on
the CPU for the (1, 1, 2) and (1, 2, 1) meshes (rank program
``tests/torch_ssm_ranks.py``, each rank on one torch thread).

* (a) the head-aligned cut (``tensor_parallel.Segments``): the cut of
  ``in_proj``, ``conv_w``, ``in_proj``'s LoRA B (also in the bank, after
  its client axis) and the conv state joins back bitwise; each rank's
  ``z``, ``x`` and ``dt`` columns are its heads, its ``B`` and ``C``
  whole at ``ssm_n_groups`` 1 and its groups at 2; the base drawn shard
  by shard equals the whole base's shard;
* (b) at (1, 1, 2) with ``remat`` off and "full": the LoRA loss and every
  gradient leaf, gathered over the model ranks, against
  ``jax.value_and_grad`` of the reference's loss; ``in_proj``'s B
  columns every rank holds (``B`` and ``C``) bitwise equal on the two
  ranks; an SGD step whose clip binds against the meshless step (an
  update is proportional to the clipped gradient, so a norm that counts
  those columns twice shows);
* (c) one FDLoRA round at (1, 1, 2) and (1, 2, 1) against the meshless
  round, by ``tests/test_torch_moe_mesh.py``'s rules;
* (d) ``ServeConfig.mesh`` at (1, 1, 2) and (1, 2, 1) with 2 shards:
  greedy streams equal the reference engine's, each slot reset on the
  rank that owns its row and reading zero state there (slots reused); a
  pool small enough to preempt gives the meshless stream; the first
  chunk's logits, gathered, against the port's meshless chunk and the
  reference's ``prefill_step``;
* (e) each rank's collective log equal to the dry run's ``train``,
  ``prefill`` and ``decode`` walks at the same mesh, and the reference's
  multi-pod mesh still skipping jamba by the count that does not divide,
  and mamba2-2.7b past its whole vocabulary to the LoRA tile's refusal
  of its 901-column in_proj shard.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ssm_ranks as R
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import (adapter_specs, init_adapters, lora_scale,
                                   tree_leaves)
from repro_torch.core.partition import spec_map
from repro_torch.federated import distributed
from repro_torch.federated.mesh_job import Case, RoundJob, run
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import first_chunk_logits
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
from repro_torch.serving.engine import ServeConfig
from repro_torch.serving.registry import AdapterRegistry, model_shard
from repro_torch.training.optimizers import sgd
from repro_torch.training.train_step import make_lora_train_step
from test_torch_moe_mesh import (OUT_TOL, REL_TOL, ROUND_TOL, _by_axis,
                                 _equal, _leaves_close)
from test_torch_ssm import POOL_TOL
from test_torch_tensor_parallel import GRAD_TOL, LOSS_TOL

ARCHS = {"mamba2-smoke": "mamba2-2.7b", "jamba-smoke": "jamba-v0.1-52b"}
MESHES = {"1x1x2": (1, 1, 2), "1x2x1": (1, 2, 1)}
B, S = 4, 16                # 2 chunks of the SSD scan's 8
N, K = 2, 1                 # the round's clients and inner steps
INNER_LR, OUTER_LR, MOMENTUM = 1e-3, 0.5, 0.5
SGD_LR, CLIP = 0.5, 0.05
SERVE = dict(batch_size=4, max_new_tokens=6, block_size=4, prefill_chunk=8,
             num_shards=2)
# 16 allocatable blocks for 4 slots of up to 8 blocks: preemption
PREEMPT = dict(SERVE, num_blocks=17)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg(name):
    """The port's config of ``name``: fp32, the smoke configs' remat."""
    return bridge.config_from_jax(j_get_config(
        ARCHS[name], smoke=True).with_overrides(dtype="float32",
                                                param_dtype="float32"))


_SETUPS = {}


def _setup(name):
    """(jcfg, jax model, jax params, port cfg, port params), fp32, the
    smoke configs' remat ("full"), built once."""
    if name not in _SETUPS:
        jcfg = j_get_config(ARCHS[name], smoke=True).with_overrides(
            dtype="float32", param_dtype="float32")
        jm = get_model(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        _SETUPS[name] = (jcfg, jm, jp, bridge.config_from_jax(jcfg),
                         bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    return _SETUPS[name]


def _tree(jcfg, seed):
    """A numpy-seeded adapter tree in the reference's layout (B non-zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        j_init_adapters(jax.random.PRNGKey(0), jcfg))


def _batch(vocab, seed, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "loss_mask": (rng.random(shape) < 0.7).astype(np.int32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _requests(vocab):
    """6 ragged requests over 4 clients and 4 slots (prompts of 5 to 24
    tokens, 3 to 6 new), so slots are reused."""
    rng = np.random.default_rng(11)
    return [(f"c{i % 4}", rng.integers(0, vocab, int(rng.integers(5, 25)))
             .astype(np.int32), int(rng.integers(3, 7))) for i in range(6)]


def _clients(jcfg):
    return {f"c{i}": _tree(jcfg, 20 + i) for i in range(4)}


# ---------------------------------------------------------------------------
# (a) the cut
# ---------------------------------------------------------------------------

def _groups_cfg(groups):
    return get_config("mamba2-2.7b", smoke=True).with_overrides(
        ssm_n_groups=groups)


@pytest.mark.parametrize("groups", [1, 2])
def test_the_head_aligned_cut_round_trips_and_gives_each_rank_its_heads(
        groups):
    cfg = _groups_cfg(groups)
    d_in, H, N_ = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_d_state
    GN, size = groups * N_, 2
    model = Model(cfg, "cpu")
    params = model.init(3)
    adapters = init_adapters(cfg, device="cpu", b_std=0.1)
    cache = model.init_paged_decode_cache(5, 4, num_slots=3)
    gen = torch.Generator().manual_seed(0)
    for c in cache["layers"]:
        c["conv"] = torch.randn(c["conv"].shape, generator=gen)
    leaves = [(param_specs(cfg)["layers"][0]["mixer"][k],
               params["layers"][0]["mixer"][k]) for k in ("in_proj",
                                                          "conv_w")]
    leaves += [(adapter_specs(cfg)["layers"][0]["mixer"]["in_proj"]["b"],
                adapters["layers"][0]["mixer"]["in_proj"]["b"]),
               (model.paged_decode_cache_specs()["layers"][0]["conv"],
                cache["layers"][0]["conv"])]
    lw = d_in // size                     # a rank's columns of z and x
    gw = GN // size if groups > 1 else GN
    for spec, t in leaves:
        parts = [tpl.shard_leaf(t, spec, size, r) for r in range(size)]
        assert torch.equal(tpl.join_leaf(spec, parts), t)
        proj = t.shape[-1] == 2 * d_in + 2 * GN + H
        for r, p in enumerate(parts):
            segs = ([("z", d_in, lw)] if proj else []) + [
                ("x", d_in, lw), ("B", GN, gw), ("C", GN, gw)] + (
                [("dt", H, H // size)] if proj else [])
            g = lo = 0
            for name, width, w in segs:
                first = r * w if w < width else 0
                assert torch.equal(p[..., lo:lo + w],
                                   t[..., g + first:g + first + w]), name
                g, lo = g + width, lo + w
            assert p.shape[-1] == lo
    mask = tpl.replicated(adapter_specs(cfg), size)["layers"][0]["mixer"]
    if groups == 1:     # B and C whole on every rank
        assert mask["in_proj"]["b"].tolist() == (
            [False] * 2 * lw + [True] * 2 * GN + [False] * (H // size))
    else:
        assert mask["in_proj"]["b"] is False
    assert mask["in_proj"]["a"] is True and mask["out_proj"]["a"] is False


def test_the_bank_and_the_base_are_cut_by_the_same_segments():
    """The bank's model shard (after its client axis), ``local_shard``
    and the base drawn shard by shard all cut as ``shard_leaf`` does."""
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    reg = AdapterRegistry(cfg, capacity=3, device="cpu")
    for i in range(3):
        reg.register(f"c{i}", init_adapters(cfg, seed=i, device="cpu",
                                            b_std=0.1))
    bank = reg.bank()
    shards = [model_shard(bank, cfg, 2, r) for r in (0, 1)]
    specs = adapter_specs(cfg)
    whole = Model(cfg, "cpu").init(5)
    for i, layer in enumerate(bank["layers"]):
        if "in_proj" not in layer.get("mixer", {}):
            continue
        spec = specs["layers"][i]["mixer"]["in_proj"]["b"]
        leaf = layer["mixer"]["in_proj"]["b"]          # (C, r, d_out)
        got = [s["layers"][i]["mixer"]["in_proj"]["b"] for s in shards]
        for c in range(3):
            assert torch.equal(tpl.join_leaf(spec, [g[c] for g in got]),
                               leaf[c])
    for rank in (0, 1):
        mesh = dryrun.RankMesh((1, 1, 2))
        mesh.get_coordinate = lambda r=rank: (0, 0, r)
        want = distributed.local_shard(whole, param_specs(cfg), mesh)
        got = Model(cfg, "cpu").init(5, shard=(2, rank))
        for (p, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w), p
        cut = spec_map(lambda s, t: tpl.shard_leaf(t, s, 2, rank),
                       param_specs(cfg), whole)
        for (p, g), (_, w) in zip(tree_leaves(cut), tree_leaves(want)):
            assert torch.equal(g, w), p


def test_what_the_ssm_cut_refuses():
    """Groups that neither divide nor are 1 are refused by name, as the
    head count that does not divide is; mamba2's attention placeholders
    (one head, no ff) are not counted."""
    with pytest.raises(ValueError, match="ssm_n_groups 4 neither divides"):
        tpl.check_model_axis(_groups_cfg(4), 8)
    local = tpl.check_model_axis(get_config("mamba2-2.7b"), 2)
    assert (local.n_heads, local.d_ff, local.vocab_size) == (1, 0, 25140)
    assert local.ssm_n_heads == 80      # the rank sizes its share by tp
    with pytest.raises(ValueError, match="does not divide"):
        tpl.segment_cut(torch.zeros(2, 12), 1, ((12, 3),), 2, 0)


# ---------------------------------------------------------------------------
# the jobs and the spawn
# ---------------------------------------------------------------------------

def _step_job(name, mesh, remat):
    jcfg, _, _, pcfg, pp = _setup(name)
    return {"kind": "step", "mesh": mesh,
            "cfg": pcfg.with_overrides(remat=remat, remat_policy="full"),
            "params": pp,
            "adapters": bridge.adapters_from_jax(_tree(jcfg, 1), "cpu"),
            "batch": _torch(_batch(jcfg.vocab_size, 2)),
            "lr": SGD_LR, "clip": CLIP}


def _round_batches(vocab):
    return [_batch(vocab, 5, (N, K, B, S))]


def _round_job(name, mesh):
    jcfg, _, _, pcfg, pp = _setup(name)
    case = (Case(None, sync=True) if mesh is None else
            Case(pod=mesh[0], data=mesh[1], model=mesh[2], sync=True))
    return RoundJob(pcfg, [case], clients=N, inner_steps=K, rows=B, seq=S,
                    rounds=1, inner_lr=INNER_LR, outer_lr=OUTER_LR,
                    outer_momentum=MOMENTUM, params=pp,
                    theta=bridge.adapters_from_jax(_tree(jcfg, 3), "cpu"),
                    batches=_round_batches(jcfg.vocab_size), device="cpu")


def _serve_job(name, mesh):
    jcfg, _, _, pcfg, pp = _setup(name)
    reqs = _requests(jcfg.vocab_size)
    return {"kind": "serve", "mesh": mesh, "params": pp,
            "clients": {c: bridge.adapters_from_jax(t, "cpu")
                        for c, t in _clients(jcfg).items()},
            "runs": [(pcfg, reqs, SERVE), (pcfg, reqs, PREEMPT)],
            "first_chunk": (pcfg, reqs, SERVE)}


def _jobs():
    jobs, keys = [], []
    for mname, mesh in MESHES.items():
        for name in ARCHS:
            for remat in ((False, True) if mesh[2] > 1 else (True,)):
                jobs.append(_step_job(name, mesh, remat))
                keys.append(("step", mname, name, remat))
            jobs.append({"kind": "round", "mesh": mesh,
                         "round": _round_job(name, mesh)})
            keys.append(("round", mname, name))
            jobs.append(_serve_job(name, mesh))
            keys.append(("serve", mname, name))
    jobs.append({"kind": "walks", "mesh": (1, 1, 2), "walks": _walk_list()})
    keys.append(("walks",))
    return jobs, keys


def _walk_list():
    """The dry run's walks (key, cfg, step, rows, seq, mesh, options) of
    each arch at each mesh: the train step (at model 2 with remat off and
    "full"), a prefill chunk and a decode step of ``SERVE``'s slots, and
    the round."""
    out = []
    K_, T = SERVE["batch_size"], SERVE["prefill_chunk"]
    paged = {"block_size": SERVE["block_size"]}
    for name in ARCHS:
        pcfg = _pcfg(name).with_overrides(paged_backend="cuda",
                                          remat_policy="full")
        for mname, mesh in MESHES.items():
            for remat in ((False, True) if mesh[2] > 1 else (True,)):
                out.append(((name, mname, "train", remat),
                            pcfg.with_overrides(remat=remat), "train", B, S,
                            mesh, {}))
            out += [((name, mname, "prefill"), pcfg, "prefill", K_, T, mesh,
                     paged),
                    ((name, mname, "decode"), pcfg, "decode", K_, 16, mesh,
                     paged),
                    ((name, mname, "round"), pcfg, "fdlora_round", N * B, S,
                     mesh, {"n_clients": N, "K": K})]
    return out


@pytest.fixture(scope="module")
def ranks():
    """Every job's results, keyed by (kind, mesh name, arch[, remat]):
    one per rank, in rank order, and the dry run's walks, which the
    ranks make last.  They run while this process computes the
    references."""
    jobs, keys = _jobs()
    got = {}

    def work():
        try:
            got["out"] = spawn(R.world, 2, jobs, device="cpu")
        except BaseException as e:      # noqa: BLE001 (re-raised)
            got["err"] = e
    t = threading.Thread(target=work)
    t.start()
    try:
        for name in ARCHS:
            _step_reference(name)
            _round_meshless(name)
            _serve_reference(name)
            _chunk_reference(name)
    finally:
        t.join()
    if "err" in got:
        raise got["err"]
    for rk in got["out"]:
        _WALKS.update({k: _by_axis(v) for k, v in rk[-1]["walks"].items()})
    return {key: [rk[i] for rk in got["out"]] for i, key in enumerate(keys)}


def _gather(specs, res, key):
    """``res``' trees under ``key`` joined over the model ranks (the
    head-aligned cut's inverse), or rank 0's where the ranks split rows;
    the other data rank's bitwise equal."""
    by_model = sorted(res, key=lambda r: r["coord"]["model"])
    if by_model[-1]["coord"]["model"] > 0:
        return spec_map(lambda s, *ls: tpl.join_leaf(s, list(ls)), specs,
                        *[r[key] for r in by_model])
    for (p, a), (_, b) in zip(tree_leaves(res[0][key]),
                              tree_leaves(res[1][key])):
        assert torch.equal(a, b), p
    return res[0][key]


# ---------------------------------------------------------------------------
# (b) the LoRA gradient and a train step at model 2
# ---------------------------------------------------------------------------

_STEP_REF = {}


def _step_reference(name):
    """The reference's (total loss, gradients) at the same adapters and
    batch, port layout, and the port's meshless SGD step."""
    if name not in _STEP_REF:
        jcfg, jm, jp, pcfg, pp = _setup(name)
        jad = jax.tree.map(jnp.asarray, _tree(jcfg, 1))
        jb = jax.tree.map(jnp.asarray, _batch(jcfg.vocab_size, 2))
        (jl, _), jg = jax.jit(jax.value_and_grad(
            j_ts.make_lora_loss_fn(jm, jcfg), has_aux=True))(jad, jp, jb)
        ad = bridge.adapters_from_jax(_tree(jcfg, 1), "cpu")
        opt = sgd(SGD_LR)
        stepped, _, _ = make_lora_train_step(
            Model(pcfg, "cpu"), pcfg, opt, clip_norm=CLIP)(
                pp, ad, opt.init(ad), _torch(_batch(jcfg.vocab_size, 2)))
        _STEP_REF[name] = (float(jl), bridge.adapters_from_jax(
            jax.tree.map(np.asarray, jg), "cpu"), stepped, ad)
    return _STEP_REF[name]


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-full"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_lora_gradient_at_model_2_matches_reference(ranks, name, remat):
    total, grads, _, _ = _step_reference(name)
    res = ranks["step", "1x1x2", name, remat]
    for r in res:
        assert float(r["own_loss"]) == pytest.approx(total, abs=LOSS_TOL)
    specs = adapter_specs(_setup(name)[3])
    got = dict(tree_leaves(_gather(specs, res, "grads")))
    want = dict(tree_leaves(grads))
    assert got.keys() == want.keys()
    assert any("in_proj" in p for p in got)
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)
    # the B and C columns of in_proj's B: one sum, the same bits on both
    whole = tpl.replicated(specs, 2)
    checked = 0
    for (p, m), (_, a), (_, b) in zip(tree_leaves(whole),
                                      tree_leaves(res[0]["grads"]),
                                      tree_leaves(res[1]["grads"])):
        if isinstance(m, torch.Tensor):
            assert torch.equal(a[..., m], b[..., m]), p
            assert not torch.equal(a[..., ~m], b[..., ~m]), p
            checked += 1
    assert checked == sum(_mamba_layers(_setup(name)[3]))


def _mamba_layers(cfg):
    return [cfg.layer_entry(i).startswith("mamba")
            for i in range(cfg.n_layers)]


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-full"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_a_step_whose_clip_binds_matches_the_meshless_step(ranks, name,
                                                           remat):
    _, grads, stepped, start = _step_reference(name)
    norm = float(torch.sqrt(sum(torch.sum(t * t)
                                for _, t in tree_leaves(grads))))
    assert norm > 2 * CLIP
    got = _gather(adapter_specs(_setup(name)[3]),
                  ranks["step", "1x1x2", name, remat], "stepped")
    want = dict(tree_leaves(stepped))
    for path, g in tree_leaves(got):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   atol=SGD_LR * GRAD_TOL, rtol=1e-5,
                                   err_msg=path)
    _leaves_close(got, stepped, 1e-4, base=start)


# ---------------------------------------------------------------------------
# (c) the FDLoRA round
# ---------------------------------------------------------------------------

_ROUND_REF = {}


def _round_meshless(name):
    if name not in _ROUND_REF:
        (_ROUND_REF[name],) = run(_round_job(name, None))
    return _ROUND_REF[name]


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_round_matches_the_meshless_round(ranks, mname, name):
    want = _round_meshless(name)
    res = [dict(r["rounds"][0], coord=r["coord"])
           for r in ranks["round", mname, name]]
    for r in res:
        assert r["loss"][0] == pytest.approx(want["loss"][0], rel=REL_TOL)
        if "aux_loss" in want:
            assert r["aux_loss"] == pytest.approx(want["aux_loss"],
                                                  rel=REL_TOL)
            assert r["objective"] == pytest.approx(want["objective"],
                                                   rel=REL_TOL)
    jcfg, _, _, pcfg, _ = _setup(name)
    got = _gather(adapter_specs(pcfg), res, "theta")
    start = bridge.adapters_from_jax(_tree(jcfg, 3), "cpu")
    _leaves_close(got, want["theta"], ROUND_TOL, base=start)


# ---------------------------------------------------------------------------
# (d) serving over ServeConfig.mesh
# ---------------------------------------------------------------------------

_SERVE_REF = {}


def _serve_reference(name):
    """The reference engine's greedy streams, and the port's meshless
    streams through a pool that preempts."""
    if name not in _SERVE_REF:
        jcfg, jm, jp, pcfg, pp = _setup(name)
        jreg = JRegistry(jcfg, capacity=4)
        for c, t in _clients(jcfg).items():
            jreg.register(c, jax.tree.map(jnp.asarray, t))
        reqs = _requests(jcfg.vocab_size)
        want = JEngine(jm, jcfg, jp, jreg).generate(
            [JRequest(c, p, max_new_tokens=b) for c, p, b in reqs],
            JServeConfig(**SERVE))
        job = _serve_job(name, None)
        eng = R.SR.build_engine(pcfg, pp, job["clients"], 4)
        preempted = eng.generate(R.SR.requests(reqs), ServeConfig(**PREEMPT))
        _SERVE_REF[name] = ([np.asarray(o) for o in want], preempted,
                            eng.last_stats)
    return _SERVE_REF[name]


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_greedy_streams_equal_the_reference_and_slots_reset_on_their_rank(
        ranks, mname, name):
    want, _, _ = _serve_reference(name)
    data = MESHES[mname][1]
    rows = SERVE["batch_size"] // data
    res = ranks["serve", mname, name]
    for r in res:
        run_ = r["runs"][0]
        _equal(run_["streams"], want)
        resets = run_["resets"]
        assert all(x["zero"] and x["rows"] == rows and 0 <= x["row"] < rows
                   for x in resets)
        assert len(resets) > len({x["row"] for x in resets})   # reused
    # each admission reset once, on the data rank that owns its slot
    owners = [r for r in res if r["coord"]["model"] == 0]
    assert sum(len(r["runs"][0]["resets"]) for r in owners) == len(want)


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_a_preempted_requests_replay_gives_the_meshless_stream(ranks, mname,
                                                               name):
    _, want, stats = _serve_reference(name)
    assert stats["preemptions"] > 0
    for r in ranks["serve", mname, name]:
        run_ = r["runs"][1]
        assert run_["stats"]["preemptions"] == stats["preemptions"]
        _equal(run_["streams"], want)
        assert all(x["zero"] for x in run_["resets"])


_CHUNK_REF = {}


def _chunk_reference(name):
    """The reference's ``prefill_step`` of the first chunk
    ``launch/serve.first_chunk_logits`` feeds (every request on a slot of
    a fresh pool), each row on its client's bank slot, the port's
    meshless chunk and the bank slots."""
    if name not in _CHUNK_REF:
        jcfg, jm, jp, pcfg, pp = _setup(name)
        eng = R.SR.build_engine(pcfg, pp, _serve_job(name, None)["clients"],
                                4)
        slots = {c: eng.registry.acquire(c) for c in _clients(jcfg)}
        reqs = R.SR.requests(_requests(jcfg.vocab_size))
        span = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        T = min(SERVE["prefill_chunk"], span - 1)
        bs = SERVE["block_size"]
        per = blocks_needed(span, bs)
        b = len(reqs)
        kv = PagedKVCache(b, bs, 1 + b * per, per)
        tokens = np.zeros((b, T), np.int32)
        n_new = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            kv.admit(i)
            n_new[i] = min(T, len(r.prompt))
            kv.ensure(i, int(n_new[i]))
            tokens[i, :n_new[i]] = r.prompt[:n_new[i]]
        trees = _clients(jcfg)
        order = sorted(trees, key=slots.get)
        bank = jax.tree.map(lambda *ls: jnp.asarray(np.stack(ls, 1)),
                            *[trees[c] for c in order])
        ids = np.asarray([slots[r.client_id] for r in reqs], np.int32)
        cache = jm.init_paged_decode_cache(b, 1 + b * per, bs)
        logits, _ = jax.jit(lambda p, c, t, n, k, a, i, bt: jm.prefill_step(
            p, c, t, n, k, adapters=a, lora_scale=lora_scale(pcfg),
            adapter_ids=i, block_tables=bt, paged_backend="jnp"))(
            jp, cache, jnp.asarray(tokens),
            jnp.asarray(kv.lengths, jnp.int32), jnp.asarray(n_new), bank,
            jnp.asarray(ids), jnp.asarray(kv.block_tables))
        with torch.no_grad():
            port, _ = first_chunk_logits(eng, reqs, ServeConfig(**SERVE))
        _CHUNK_REF[name] = (np.asarray(logits), n_new, port.numpy(), slots)
    return _CHUNK_REF[name]


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_first_chunk_logits_gathered_match_reference(ranks, mname, name):
    """The ranks' chunk, gathered, against the port's meshless chunk and
    the reference's: within ``OUT_TOL`` of the largest logit (fp32 order
    noise) on mamba2, within ``POOL_TOL`` on jamba, whose attention
    layers read bf16 pools (a K/V value whose rounding falls the other
    way moves the logits by up to that; the port's meshless chunk sits
    1.3e-4 from the reference's: ``tests/test_torch_ssm.py``)."""
    res = ranks["serve", mname, name]
    chunks = [r["first_chunk"] for r in sorted(
        res, key=lambda r: (r["coord"]["data"], r["coord"]["model"]))]
    want, n_new, meshless, slots = _chunk_reference(name)
    assert all(c["slots"] == slots for c in chunks)
    if MESHES[mname][2] > 1:
        got = torch.cat([c["logits"] for c in chunks], -1)
    else:
        got = torch.cat([c["logits"] for c in chunks], 0)
    np.testing.assert_array_equal(
        torch.cat([c["n_new"] for c in chunks]
                  if MESHES[mname][1] > 1 else [chunks[0]["n_new"]]).numpy(),
        n_new)
    valid = np.arange(want.shape[1])[None, :] < n_new[:, None]
    tol = (POOL_TOL if _setup(name)[3].has_mixer("attn")
           else OUT_TOL * np.abs(want[valid]).max())
    for ref in (meshless, want):
        assert np.abs(got.numpy()[valid] - ref[valid]).max() <= tol


# ---------------------------------------------------------------------------
# (e) the collectives against the dry run's walks
# ---------------------------------------------------------------------------

_WALKS = {}     # the ranks' dry-run walks: key -> {(axis, group, bytes): n}


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("key", [("1x1x2", False), ("1x1x2", True),
                                 ("1x2x1", True)],
                         ids=["1x1x2-remat-off", "1x1x2-remat-full",
                              "1x2x1"])
def test_train_collectives_equal_the_dry_run(ranks, key, name):
    """At model 2 per mamba layer the norm's (B, S, 1) fp32 sum forward
    and backward and ``out_proj``'s (B, S, d) sum, plus the recomputed
    forward's under remat "full"; the input's backward sum from the
    second layer on."""
    mname, remat = key
    want = _WALKS[name, mname, "train", remat]
    if MESHES[mname][2] > 1:
        n = sum(_mamba_layers(_pcfg(name)))
        assert want[("model", 2, B * S * 4)] == n * (3 if remat else 2)
    for r in ranks["step", mname, name, remat]:
        assert _by_axis(r["collectives"]) == want


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_serve_and_round_collectives_equal_the_dry_run(ranks, mname, name):
    walks = {k: _WALKS[name, mname, k] for k in ("prefill", "decode",
                                                  "round")}
    for r in ranks["serve", mname, name]:
        for run_ in r["runs"]:
            st, want = run_["stats"], {}
            for s, n in (("prefill", st["prefill_dispatches"]),
                         ("decode", st["decode_steps"])):
                for key, c in walks[s].items():
                    want[key] = want.get(key, 0) + n * c
            assert _by_axis(run_["collectives"]) == want
    for r in ranks["round", mname, name]:
        (log,) = r["rounds"][0]["collectives"]
        assert _by_axis(log) == walks["round"]


@pytest.mark.parametrize("arch,match", [
    ("mamba2-2.7b", "N = 901 must be multiples of 8"),
    ("jamba-v0.1-52b", "n_kv_heads 8 does not divide")])
def test_the_multi_pod_mesh_skips_the_full_archs_by_their_counts(
        arch, match, tmp_path):
    """jamba is skipped by its kv heads.  mamba2-2.7b's vocabulary of
    50,280, which 16 does not divide, is whole on every rank (the walk's
    meta shard holds the whole 50,280 x 2,560 embedding), so it passes
    the model axis's check; its in_proj shard of 901 columns (320 z, 320
    x, 128 B, 128 C, 5 dt) then meets the bf16 LoRA tile, whose 16-byte
    row copies refuse a width that is not a multiple of 8."""
    cfg = get_config(arch)
    if arch == "mamba2-2.7b":
        assert tpl.check_model_axis(cfg, 16).vocab_size == 50280
        params, _ = dryrun._params_adapters(Model(cfg, "meta"), cfg,
                                            dryrun.RankMesh((2, 16, 16)))
        assert params["embed"].shape == (50280, 2560)
        with pytest.raises(ValueError, match=match):
            dryrun.run_one(arch, "train_4k", mesh=(2, 16, 16),
                           out_dir=str(tmp_path))
    else:
        res = dryrun.run_one(arch, "train_4k", mesh=(2, 16, 16),
                             out_dir=str(tmp_path))
        assert res["skipped"] and match in res["reason"]
    tpl.check_model_axis(cfg, 2)

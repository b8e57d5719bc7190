"""The MoE layer over a ``("pod", "data", "model")`` mesh against the
reference's meshless computation (what GSPMD computes under any mesh), on
dbrx-smoke, kimi-smoke, ``tiny_moe`` and jamba-smoke in fp32, with gloo
ranks on the CPU (rank program ``tests/torch_moe_ranks.py``: one spawn of
2 ranks for the (1, 1, 2) and (1, 2, 1) meshes, one of 4 for (1, 2, 2),
each rank on one torch thread).  Weights come from the reference init,
bridged; adapters and batches are numpy-seeded.

* ``apply_moe`` with experts over "model" and rows over "data", at
  capacity factors 1.25 and 0.25: the output within 1e-5 of its largest
  value, the aux loss, each copy's expert and the keep mask equal the
  reference's; at 0.25 capacity binds across the data ranks (a rank's
  own rows dispatched alone keep other copies), and the port's layer
  run on each rank's rows alone misses the reference;
* the LoRA gradient and one SGD train step whose clip binds: loss,
  ``aux_loss`` and every adapter gradient against ``jax.value_and_grad``
  of the reference's loss, the stepped adapters against its
  ``make_lora_train_step``; the router's aux coefficient is raised to 1
  so that the aux term weighs in the gradient, and the ranks' own losses
  sum to the reference's, so the aux term counts once in the loss, the
  metric and the gradient;
* the FDLoRA round's θ_s' and loss against the reference's round, and
  jamba-smoke's round at data 2;
* greedy streams through ``ServeConfig.mesh`` equal to the reference
  engine's with a prefill chunk whose capacity binds across the data
  ranks, and speculative decoding equal to sequential under the mesh;
* routing ids bitwise equal across the model ranks, and each rank's
  collective log equal to the dry run's walk of the same step;
* the base drawn shard by shard (``Model.init(shard=)``) equal to the
  local shard of the whole base, the dry run's per-rank argument bytes,
  and the counts that must divide (``n_experts`` included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_ranks as R
from conftest import tiny_moe
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.core.outer_opt import make_outer_optimizer as j_outer_opt
from repro.federated import distributed as j_dist
from repro.models import moe as j_moe
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro.training import optimizers as j_opt
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import adapter_specs, tree_leaves
from repro_torch.federated import distributed
from repro_torch.federated.mesh_job import Case, RoundJob
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from test_torch_tensor_parallel import _gather

ARCHS = ["dbrx-smoke", "kimi-smoke"]
MESHES = {"1x1x2": (1, 1, 2), "1x2x1": (1, 2, 1), "1x2x2": (1, 2, 2)}
WORLD2, WORLD4 = ["1x1x2", "1x2x1"], ["1x2x2"]
FACTORS = [1.25, 0.25]
OUT_TOL = 1e-5           # of the output's largest value (fp32 order noise)
REL_TOL = 1e-5           # loss and aux, relative
GRAD_TOL = 1e-4          # of each gradient leaf's norm
B, S = 4, 40             # 160 tokens, top-2 of 4 experts: ~80 copies each
N, K = 2, 1              # the round's clients and inner steps
INNER_LR, OUTER_LR, MOMENTUM = 1e-3, 0.5, 0.5
SGD_LR, CLIP = 0.5, 0.05
# θ_s' per leaf, of its travel from θ_s: AdamW's first step is about
# lr·sign(g), so an element whose gradient is fp32 noise near zero moves
# by up to 2·lr on one side and not the other; the port's meshless round
# sits 0.27-0.49% of the travel from the reference's here (one such
# element a leaf), a wrong capacity or a doubled aux term moves whole
# leaves
ROUND_TOL = 0.02
SPEC_ARCH = "dbrx-smoke"     # the speculative stream's arch
SERVE = dict(batch_size=4, max_new_tokens=16, block_size=4, prefill_chunk=32,
             num_shards=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {"dbrx-smoke": lambda: j_get_config("dbrx-132b", smoke=True),
         "kimi-smoke": lambda: j_get_config("kimi-k2-1t-a32b", smoke=True),
         "tiny_moe": lambda: tiny_moe(),
         "jamba-smoke": lambda: j_get_config("jamba-v0.1-52b", smoke=True)}


def _jcfg(name, factor=0.25):
    """fp32, capacity factor ``factor``, the aux term at weight 1."""
    return CASES[name]().with_overrides(
        dtype="float32", param_dtype="float32", moe_capacity_factor=factor,
        router_aux_loss_coef=1.0)


_SETUPS = {}


def _setup(name):
    """(jcfg, jax model, jax params, port cfg, port params), built once."""
    if name not in _SETUPS:
        jcfg = _jcfg(name)
        jm = get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _SETUPS[name] = (jcfg, jm, jp, bridge.config_from_jax(jcfg),
                         bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    return _SETUPS[name]


def _tree(jcfg, seed):
    """A numpy-seeded adapter tree in the reference's layout (B non-zero,
    the router's pair included)."""
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


# ---------------------------------------------------------------------------
# the jobs each world runs, and the spawns
# ---------------------------------------------------------------------------

def _layer(name, factor):
    """A layer's weights from the reference init and an input batch."""
    jcfg = _jcfg("tiny_moe" if name == "tiny_moe" else name, factor)
    jp = j_moe.init_moe(jax.random.PRNGKey(3), jcfg.d_model,
                        jcfg.resolved_d_ff_moe, jcfg.n_experts,
                        jcfg.mlp_type, jnp.float32)
    x = np.random.default_rng(7).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, x


def _serve_requests(vocab):
    """8 ragged requests over 4 clients (prompts of 5 to 40 tokens); the
    second and sixth repeat a trigram, so the drafter proposes."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(8):
        p = rng.integers(0, vocab, int(rng.integers(5, 41))).astype(np.int32)
        if i in (1, 5):
            p = np.tile(p[:3], 6)
        reqs.append((f"c{i % 4}", p, int(rng.integers(8, 17))))
    return reqs


def _clients(jcfg):
    return {f"c{i}": _tree(jcfg, 20 + i) for i in range(4)}


def _jobs(names):
    """Every job of the meshes ``names``; keys name them in order."""
    jobs, keys = [], []
    for mname in names:
        mesh = MESHES[mname]
        for arch in ARCHS + ["tiny_moe"]:
            for f in FACTORS:
                jcfg, jp, x = _layer(arch, f)
                jobs.append({"kind": "moe", "mesh": mesh,
                             "cfg": bridge.config_from_jax(jcfg),
                             "params": _torch(jp),
                             "x": torch.from_numpy(x)})
                keys.append(("moe", mname, arch, f))
        for arch in ARCHS:
            jcfg, _, _, pcfg, pp = _setup(arch)
            jobs.append({"kind": "step", "mesh": mesh, "cfg": pcfg,
                         "params": pp, "adapters": bridge.adapters_from_jax(
                             _tree(jcfg, 1), device="cpu"),
                         "batch": _torch(_batch(jcfg.vocab_size, 2)),
                         "lr": SGD_LR, "clip": CLIP})
            keys.append(("step", mname, arch))
        for arch in ARCHS + (["jamba-smoke"] if mname == "1x2x1" else []):
            jobs.append({"kind": "round", "mesh": mesh,
                         "round": _round_job(arch, mesh)})
            keys.append(("round", mname, arch))
        for arch in ARCHS:
            jobs.append(_serve_job(arch, mesh))
            keys.append(("serve", mname, arch))
        if mname == "1x1x2":
            jobs.append({"kind": "package", "mesh": mesh,
                         "tasks": _package_tasks(mesh)})
            keys.append(("package", mname, "dbrx-smoke"))
    return jobs, keys


def _package_cfg():
    return get_config("dbrx-132b", smoke=True).with_overrides(
        dtype="float32", param_dtype="float32")


def _package_jobs(mesh):
    """A ``ServeJob`` and a ``RoundJob`` of dbrx-smoke from seed 3, on
    ``mesh`` (None: meshless)."""
    from repro_torch.launch.serve import ServeJob, ragged_requests
    cfg = _package_cfg()
    reqs = ragged_requests(4, 4, cfg.vocab_size, 5, 30, seed=3)
    kw = dict(batch_size=4, max_new_tokens=6, block_size=4, prefill_chunk=8)
    serve = ServeJob(cfg, reqs, [("run", mesh, kw)], tenants=4, seed=3,
                     device="cpu", first_chunk=("run",))
    case = (Case(pod=None, sync=True) if mesh is None else
            Case(pod=mesh[0], data=mesh[1], model=mesh[2], sync=True))
    rounds = RoundJob(cfg, [case], clients=2, inner_steps=1, rows=2, seq=32,
                      seed=3, device="cpu")
    return serve, rounds


def _package_tasks(mesh):
    from repro_torch.federated.mesh_job import run_jobs
    from repro_torch.launch.serve import mesh_serve
    serve, rounds = _package_jobs(mesh)
    return [(mesh_serve, (serve,)), (run_jobs, ([rounds],))]


def _round_batches(vocab):
    rng = np.random.default_rng(5)
    shape = (N, K, B, S)
    return [{"tokens": rng.integers(0, vocab, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) < 0.7).astype(np.int32)}]


def _round_job(arch, mesh):
    jcfg, _, _, pcfg, pp = _setup(arch)
    return RoundJob(pcfg, [Case(pod=mesh[0], data=mesh[1], model=mesh[2],
                                sync=True)],
                    clients=N, inner_steps=K, rows=B, seq=S, rounds=1,
                    inner_lr=INNER_LR, outer_lr=OUTER_LR,
                    outer_momentum=MOMENTUM, params=pp,
                    theta=bridge.adapters_from_jax(_tree(jcfg, 3),
                                                   device="cpu"),
                    batches=_round_batches(jcfg.vocab_size), device="cpu")


def _serve_job(arch, mesh):
    """At capacity factor 0.25 the plain stream (32-token chunks over 4
    slots bind); for dbrx-smoke at 1.25, where no dispatch drops a copy,
    the plain stream and the speculative one too."""
    jcfg, _, _, pcfg, pp = _setup(arch)
    free = pcfg.with_overrides(moe_capacity_factor=1.25)
    reqs = _serve_requests(jcfg.vocab_size)
    runs = [(pcfg, reqs, SERVE)]
    if arch == SPEC_ARCH:
        runs += [(free, reqs, SERVE),
                 (free, reqs, dict(SERVE, spec_decode=True))]
    return {"kind": "serve", "mesh": mesh, "params": pp,
            "clients": {c: bridge.adapters_from_jax(t, device="cpu")
                        for c, t in _clients(jcfg).items()},
            "runs": runs}


def _spawn(world, names):
    jobs, keys = _jobs(names)
    ranks = spawn(R.world, world, jobs, device="cpu")
    return {key: [rk[i] for rk in ranks] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def ranks():
    """Every job's results, keyed by (kind, mesh name, arch[, factor]):
    one per rank, in rank order."""
    out = _spawn(2, WORLD2)
    out.update(_spawn(4, WORLD4))
    return out


def _by_model(results, data=0):
    """The results of data coordinate ``data``, in model order."""
    return sorted((r for r in results if r["coord"]["data"] == data),
                  key=lambda r: r["coord"]["model"])


def _data_ranks(results):
    """One result per data coordinate (model coordinate 0), in order."""
    return sorted((r for r in results if r["coord"]["model"] == 0),
                  key=lambda r: r["coord"]["data"])


# ---------------------------------------------------------------------------
# apply_moe alone
# ---------------------------------------------------------------------------

_MOE_REF = {}


def _moe_reference(arch, factor):
    """The reference's (out, aux, ids, keep) on the whole batch."""
    key = (arch, factor)
    if key not in _MOE_REF:
        jcfg, jp, x = _layer(arch, factor)
        ids = []
        orig = j_moe._top_k_routing

        def routing(logits, k):
            out = orig(logits, k)
            ids.append(np.asarray(out[1]))
            return out
        j_moe._top_k_routing = routing
        try:
            out, aux = j_moe.apply_moe(jp, jnp.asarray(x), jcfg)
        finally:
            j_moe._top_k_routing = orig
        E, k = jcfg.n_experts, jcfg.n_experts_per_tok
        keep = _keep_from_ids(ids[0], E, moe.capacity(B * S, k, E, factor))
        _MOE_REF[key] = (np.asarray(out), float(aux), ids[0], keep)
    return _MOE_REF[key]


def _keep_from_ids(ids, E, cap):
    """A copy fits when fewer than ``cap`` earlier copies in flat order
    chose its expert."""
    seen = np.zeros(E, np.int64)
    keep = []
    for e in ids.reshape(-1):
        keep.append(seen[e] < cap)
        seen[e] += 1
    return np.asarray(keep)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS + ["tiny_moe"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_apply_moe_matches_reference(ranks, mname, arch, factor):
    want, aux, ids, keep = _moe_reference(arch, factor)
    res = ranks["moe", mname, arch, factor]
    data = MESHES[mname][1]
    for d in range(data):       # the model ranks agree bit for bit
        grp = _by_model(res, d)
        for r in grp[1:]:
            assert torch.equal(r["out"], grp[0]["out"])
            assert torch.equal(r["ids"][0], grp[0]["ids"][0])
    got = torch.cat([r["out"] for r in _data_ranks(res)]).numpy()
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    for r in res:
        assert float(r["aux"]) == pytest.approx(aux, rel=REL_TOL)
        # every rank dispatches every copy in flat order: the keep mask
        np.testing.assert_array_equal(r["keep"][0].numpy(), keep)
    np.testing.assert_array_equal(
        torch.cat([r["ids"][0] for r in _data_ranks(res)]).numpy(), ids)
    if factor < 1:
        assert not keep.all(), "capacity did not bind"
        if data > 1:
            assert all(r["binds"] == [True] for r in res)


@pytest.mark.parametrize("arch", ARCHS + ["tiny_moe"])
def test_capacity_of_a_data_ranks_own_rows_misses_the_reference(arch):
    """The fault the data group's dispatch prevents: each rank's rows
    through the layer alone (capacity from their own T, slots numbered
    among their own copies) give finite, plausible and wrong outputs."""
    jcfg, jp, x = _layer(arch, 0.25)
    want = _moe_reference(arch, 0.25)[0]
    pcfg = bridge.config_from_jax(jcfg)
    alone = torch.cat([moe.apply_moe(_torch(jp), torch.from_numpy(h),
                                     pcfg)[0] for h in np.split(x, 2)])
    assert np.isfinite(alone.numpy()).all()
    assert np.abs(alone.numpy() - want).max() > 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the LoRA gradient and train step
# ---------------------------------------------------------------------------

_STEP_REF = {}


def _step_reference(arch):
    """The reference's (total loss, metrics, gradients, SGD-stepped
    adapters, adapters), port layout."""
    if arch not in _STEP_REF:
        jcfg, jm, jp, _, _ = _setup(arch)
        jad = jax.tree.map(jnp.asarray, _tree(jcfg, 1))
        jb = jax.tree.map(jnp.asarray, _batch(jcfg.vocab_size, 2))
        (jl, jmet), jg = jax.jit(jax.value_and_grad(
            j_ts.make_lora_loss_fn(jm, jcfg), has_aux=True))(jad, jp, jb)
        jo = j_opt.sgd(SGD_LR)
        stepped, _, _ = jax.jit(j_ts.make_lora_train_step(
            jm, jcfg, jo, clip_norm=CLIP))(jp, jad, jo.init(jad), jb)

        def port(t):
            return bridge.adapters_from_jax(jax.tree.map(np.asarray, t),
                                            "cpu")
        _STEP_REF[arch] = (float(jl), {k: float(v) for k, v in jmet.items()},
                           port(jg), port(stepped), port(jad))
    return _STEP_REF[arch]


def _leaves_close(got, want, tol, base=None):
    """Per leaf ``‖got - want‖ <= tol · ‖want - base‖`` (base 0)."""
    got, exp = dict(tree_leaves(got)), dict(tree_leaves(want))
    ref = dict(tree_leaves(base)) if base is not None else None
    assert got.keys() == exp.keys()
    for path in got:
        w = exp[path] - (ref[path] if ref else 0)
        g = got[path] - (ref[path] if ref else 0)
        assert float((g - w).norm()) <= tol * float(w.norm()) + 1e-12, path


def _gathered(specs, res, key):
    """``res``' trees under ``key`` gathered over the model ranks of each
    data coordinate; the data coordinates agree bit for bit."""
    groups = {}
    for r in res:
        groups.setdefault(r["coord"]["data"], []).append(r)
    trees = [_gather(specs, [r[key] for r in sorted(
        g, key=lambda r: r["coord"]["model"])])
        for _, g in sorted(groups.items())]
    for t in trees[1:]:
        for (p, a), (_, b) in zip(tree_leaves(t), tree_leaves(trees[0])):
            assert torch.equal(a, b), p
    return trees[0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_lora_gradient_and_aux_count_once_as_the_reference(ranks, mname,
                                                           arch):
    """The loss and ``aux_loss`` metrics, each adapter leaf's gradient
    (the router's pair and the MLP input's, through the attention's
    pairs, included), and each data rank's own loss: their sum is the
    reference's loss, aux term once."""
    total, met, grads, _, _ = _step_reference(arch)
    assert met["aux_loss"] > 0 and not np.isclose(total, met["loss"])
    res = ranks["step", mname, arch]
    for r in res:
        assert float(r["metrics"]["loss"]) == pytest.approx(met["loss"],
                                                            rel=REL_TOL)
        assert float(r["metrics"]["aux_loss"]) == pytest.approx(
            met["aux_loss"], rel=REL_TOL)
    own = sum(float(r["own_loss"]) for r in _data_ranks(res))
    assert own == pytest.approx(total, rel=REL_TOL)
    got = _gathered(adapter_specs(_setup(arch)[3]), res, "grads")
    assert any("router" in p for p, _ in tree_leaves(got))
    _leaves_close(got, grads, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_a_train_step_whose_clip_binds_matches_reference(ranks, mname,
                                                         arch):
    """One SGD step clipped at ``CLIP`` (the gradient's norm is well
    above it, so a per-rank norm or a gradient counted twice shows):
    each leaf's update against the reference's step's."""
    _, _, grads, stepped, start = _step_reference(arch)
    norm = float(torch.sqrt(sum(torch.sum(t * t)
                                for _, t in tree_leaves(grads))))
    assert norm > 2 * CLIP
    res = ranks["step", mname, arch]
    got = _gathered(adapter_specs(_setup(arch)[3]), res, "stepped")
    _leaves_close(got, stepped, GRAD_TOL, base=start)


def _by_axis(log):
    out = {}
    for c in log:
        key = (c["axis"], c["group"], c["bytes"])
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_train_step_collectives_equal_the_dry_run(ranks, mname, arch):
    """The step's collectives, one by one in bytes: per MoE layer at data
    2 one gather of the (T_local, k) int32 ids and one (2, E) fp32 sum
    forward, each issued again by the recomputed forward in backward (the
    smoke configs' ``remat`` "full"); at model 2 one (T, d) fp32 sum of
    the experts' partials."""
    pcfg = _setup(arch)[3].with_overrides(paged_backend="cuda")
    mesh = MESHES[mname]
    dry = dryrun.dry_run(pcfg, "train", B, S, mesh=mesh)
    want = _by_axis(dry["collectives"])
    E, k, d = pcfg.n_experts, pcfg.n_experts_per_tok, pcfg.d_model
    rows = B // mesh[1]
    forwards = 2 if pcfg.remat else 1
    if mesh[1] > 1:
        assert want[("data", 2, 2 * rows * S * k * 4)] == (forwards
                                                          * pcfg.n_layers)
        assert want[("data", 2, 2 * E * 4)] == forwards * pcfg.n_layers
    if mesh[2] > 1:     # the attention's and the experts' sums, fp32
        assert want[("model", 2, rows * S * d * 4)] >= 2 * pcfg.n_layers
    for r in ranks["step", mname, arch]:
        assert _by_axis(r["collectives"]) == want


# ---------------------------------------------------------------------------
# the FDLoRA round
# ---------------------------------------------------------------------------

_ROUND_REF = {}


def _round_reference(arch):
    """The reference's round on the same θ_s and batches: (θ_s', loss,
    the LoRA loss and aux metric at θ_s' on client 0's first step batch),
    port layout."""
    if arch not in _ROUND_REF:
        jcfg, jm, jp, _, _ = _setup(arch)
        inner = j_opt.adamw(lr=INNER_LR, weight_decay=0.01)
        outer = j_outer_opt("nesterov", lr=OUTER_LR, momentum=MOMENTUM)
        step = jax.jit(j_dist.make_fdlora_round_step(
            jm, jcfg, inner, outer, K, sync_personalized=True))
        th = jax.tree.map(jnp.asarray, _tree(jcfg, 3))
        st = {"inner_opt": jax.tree.map(lambda x: jnp.stack([x] * N),
                                        inner.init(th)),
              "outer_opt": outer.init(th)}
        (b,) = _round_batches(jcfg.vocab_size)
        th, _, loss = step(jp, th, st, jax.tree.map(jnp.asarray, b))
        total, met = j_ts.make_lora_loss_fn(jm, jcfg)(
            th, jp, {k: jnp.asarray(v[0, 0]) for k, v in b.items()})
        _ROUND_REF[arch] = (bridge.adapters_from_jax(
            jax.tree.map(np.asarray, th), "cpu"), float(loss),
            float(total), float(met["aux_loss"]))
    return _ROUND_REF[arch]


def _round_cases():
    return [(m, a) for m in MESHES for a in ARCHS] + [("1x2x1",
                                                       "jamba-smoke")]


@pytest.mark.parametrize("mname,arch", _round_cases(),
                         ids=[f"{m}-{a}" for m, a in _round_cases()])
def test_round_matches_reference(ranks, mname, arch):
    """θ_s' and the loss against the reference's round, and at θ_s' the
    LoRA loss (the data ranks' shares summed: the aux term once) and its
    aux metric against the reference's loss function."""
    theta, loss, objective, aux = _round_reference(arch)
    res = [dict(r["rounds"][0], coord=r["coord"])
           for r in ranks["round", mname, arch]]
    for r in res:
        assert r["loss"][0] == pytest.approx(loss, rel=REL_TOL)
        assert r["objective"] == pytest.approx(objective, rel=REL_TOL)
        assert r["aux_loss"] == pytest.approx(aux, rel=REL_TOL)
    got = _gathered(adapter_specs(_setup(arch)[3]), res, "theta")
    start = bridge.adapters_from_jax(_tree(_setup(arch)[0], 3), "cpu")
    _leaves_close(got, theta, ROUND_TOL, base=start)
    if MESHES[mname][1] > 1:    # a client's batch binds across its ranks
        assert any(any(r["binds"]) for r in ranks["round", mname, arch])


@pytest.mark.parametrize("mname,arch", _round_cases(),
                         ids=[f"{m}-{a}" for m, a in _round_cases()])
def test_round_collectives_equal_the_dry_run(ranks, mname, arch):
    pcfg = _setup(arch)[3].with_overrides(paged_backend="cuda")
    dry = dryrun.dry_run(pcfg, "fdlora_round", N * B, S, mesh=MESHES[mname],
                         n_clients=N, K=K)
    want = _by_axis(dry["collectives"])
    for r in ranks["round", mname, arch]:
        (log,) = r["rounds"][0]["collectives"]
        assert _by_axis(log) == want


# ---------------------------------------------------------------------------
# serving over ServeConfig.mesh
# ---------------------------------------------------------------------------

_SERVE_REF = {}


def _serve_reference(arch):
    """The reference engine's greedy streams at capacity factor 0.25."""
    if arch not in _SERVE_REF:
        jcfg, jm, jp, _, _ = _setup(arch)
        jreg = JRegistry(jcfg, capacity=4)
        for c, t in _clients(jcfg).items():
            jreg.register(c, jax.tree.map(jnp.asarray, t))
        out = JEngine(jm, jcfg, jp, jreg).generate(
            [JRequest(c, p, max_new_tokens=b)
             for c, p, b in _serve_requests(jcfg.vocab_size)],
            JServeConfig(**SERVE))
        _SERVE_REF[arch] = [np.asarray(o) for o in out]
    return _SERVE_REF[arch]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_greedy_streams_equal_the_reference_engine(ranks, mname, arch):
    """Capacity factor 0.25, 32-token chunks over 4 slots: a chunk's
    dispatch drops copies, and at data 2 it binds across the ranks."""
    want = _serve_reference(arch)
    res = ranks["serve", mname, arch]
    for r in res:
        run = r["runs"][0]
        _equal(run["streams"], want)
        assert run["stats"]["mesh"] == dict(zip(("pod", "data", "model"),
                                                MESHES[mname]))
        assert not all(bool(k.all()) for k in run["keep"])
    if MESHES[mname][1] > 1:
        assert all(any(r["runs"][0]["binds"]) for r in res)


@pytest.mark.parametrize("mname", list(MESHES))
def test_spec_decode_equals_sequential_under_the_mesh(ranks, mname):
    """dbrx-smoke at capacity factor 1.25, where no dispatch drops a copy
    (the verify chunk's capacity is not the decode step's, so a binding
    one would differ, in the reference too)."""
    for r in ranks["serve", mname, SPEC_ARCH]:
        _, plain, spec = r["runs"]
        assert all(bool(k.all()) for k in plain["keep"] + spec["keep"])
        _equal(spec["streams"], plain["streams"])
        assert spec["stats"]["verify_dispatches"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_serve_collectives_equal_the_dry_run(ranks, mname, arch):
    """A stream's collectives are its prefill dispatches' and decode
    steps', each the dry run's walk of the step at the mesh (no aux sum:
    serving drops the aux loss)."""
    pcfg = _setup(arch)[3].with_overrides(paged_backend="cuda")
    mesh = MESHES[mname]
    K_, T = SERVE["batch_size"], SERVE["prefill_chunk"]
    walks = {s: _by_axis(dryrun.dry_run(
        pcfg, s, K_, T if s == "prefill" else 16, mesh=mesh,
        block_size=SERVE["block_size"])["collectives"])
        for s in ("prefill", "decode")}
    for r in ranks["serve", mname, arch]:
        run = r["runs"][0]
        st, want = run["stats"], {}
        for s, n in (("prefill", st["prefill_dispatches"]),
                     ("decode", st["decode_steps"])):
            for key, c in walks[s].items():
                want[key] = want.get(key, 0) + n * c
        assert _by_axis(run["collectives"]) == want
    if mesh[1] > 1:     # per MoE layer one gather of the ids, no aux sum
        E = pcfg.n_experts
        assert ("data", 2, 2 * E * 4) not in walks["prefill"]
        assert walks["decode"][("data", 2, 2 * (K_ // 2) * 2 * 4)] == \
            pcfg.n_layers


# ---------------------------------------------------------------------------
# routing across the model ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["step", "round", "serve"])
@pytest.mark.parametrize("mname", ["1x1x2", "1x2x2"])
def test_routing_is_bitwise_equal_across_the_model_ranks(ranks, mname,
                                                         kind):
    for arch in ARCHS:
        res = ranks[kind, mname, arch]
        for d in range(MESHES[mname][1]):
            a, b = _by_model(res, d)
            ids = [r["ids"] if kind != "serve" else
                   [i for run in r["runs"] for i in run["ids"]]
                   for r in (a, b)]
            assert len(ids[0]) == len(ids[1]) > 0
            for x, y in zip(*ids):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the pieces: weights drawn shard by shard, the dry run, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_a_shard_drawn_as_it_is_cut_is_the_whole_bases_shard(arch):
    cfg = get_config(arch, smoke=True)
    whole = Model(cfg, "cpu").init(5)
    for rank in (0, 1):
        mesh = dryrun.RankMesh((1, 1, 2))
        mesh.get_coordinate = lambda r=rank: (0, 0, r)
        want = distributed.local_shard(whole, param_specs(cfg), mesh)
        got = Model(cfg, "cpu").init(5, shard=(2, rank))
        assert ([p for p, _ in tree_leaves(got)]
                == [p for p, _ in tree_leaves(want)])
        for (p, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w), p
        assert got["layers"][0]["mlp"]["w_up"].shape[0] == \
            cfg.n_experts // 2


@pytest.mark.parametrize("step", ["train", "decode"])
def test_dry_run_argument_bytes_hold_the_ranks_experts(step):
    cfg = get_config("dbrx-132b", smoke=True).with_overrides(
        paged_backend="cuda")
    mesh = dryrun.RankMesh((1, 1, 2))
    res = dryrun.dry_run(cfg, step, 4, 16, mesh=(1, 1, 2))
    params = distributed.local_shard(Model(cfg, "cpu").init(0),
                                     param_specs(cfg), mesh)
    ex = sum(t.numel() * t.element_size() for p, t in tree_leaves(params)
             if "mlp" in p and "router" not in p)
    whole = sum(t.numel() * t.element_size()
                for p, t in tree_leaves(Model(cfg, "cpu").init(0))
                if "mlp" in p and "router" not in p)
    assert 2 * ex == whole
    assert res["memory"]["argument_bytes_by"]["params"] == sum(
        t.numel() * t.element_size() for _, t in tree_leaves(params))


def test_local_config_keeps_the_experts_and_pins_their_width():
    cfg = get_config("dbrx-132b")
    local = tpl.check_model_axis(cfg, 8)
    assert (local.n_heads, local.n_kv_heads, local.n_experts,
            local.d_ff_moe, local.d_ff) == (6, 1, 16, 10752, 1344)
    kimi = tpl.local_config(get_config("kimi-k2-1t-a32b").with_overrides(
        d_ff_moe=0), 8)
    assert kimi.resolved_d_ff_moe == 2048 and kimi.n_experts == 384
    with pytest.raises(ValueError, match="n_experts 3 does not divide"):
        tpl.check_model_axis(get_config("dbrx-132b", smoke=True)
                             .with_overrides(n_experts=3), 2)
    with pytest.raises(ValueError, match="n_kv_heads 8"):
        tpl.check_model_axis(get_config("internvl2-26b"), 16)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_multi_pod_still_skips_the_moe_archs_by_their_kv_heads(arch,
                                                               tmp_path):
    res = dryrun.run_one(arch, "train_4k", mesh=(2, 16, 16),
                         out_dir=str(tmp_path))
    assert res["skipped"]
    assert "n_kv_heads 8 does not divide" in res["reason"]


def test_dry_run_cli_walks_an_moe_arch_on_a_mesh(tmp_path, capsys):
    """``--mesh P,D,M``: one rank of that mesh, per-rank bytes, the
    experts split over "model" (dbrx-smoke's 2 kv heads bound it at 2)."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "dbrx-132b", "--shape", "decode_32k",
                        "--smoke", "--mesh", "1,1,2", "--out-dir", out]) == 0
    assert "OK dbrx-132b decode_32k 1x1x2 decode" in capsys.readouterr().out
    res = dryrun.run_one("dbrx-132b", "decode_32k", smoke=True,
                         mesh=(1, 1, 2), out_dir=out)
    whole = dryrun.run_one("dbrx-132b", "decode_32k", smoke=True,
                           out_dir=out)
    assert res["mesh_shape"] == {"pod": 1, "data": 1, "model": 2}
    assert res["memory"]["argument_bytes_by"]["params"] < \
        whole["memory"]["argument_bytes_by"]["params"]
    assert any(c["axis"] == "model" for c in res["collectives"])
    skipped = dryrun.run_one("dbrx-132b", "decode_32k", smoke=True,
                             mesh=(1, 1, 4), out_dir=out)
    assert skipped["skipped"] and "n_kv_heads 2" in skipped["reason"]


def test_the_packages_rank_programs_draw_their_shards_and_match_meshless(
        ranks):
    """``launch/serve.mesh_serve`` and ``mesh_job.run_jobs`` in one
    ``run_each`` at (1, 1, 2), each rank drawing its shard of the base as
    it is cut (no whole base): the streams, the first chunk's routing
    (bitwise across the ranks), θ_s' gathered over the ranks, the loss
    and the aux metric against the meshless programs in this process."""
    from repro_torch.federated.mesh_job import run
    from repro_torch.launch.serve import build_engine, serve_runs
    serve, rounds = _package_jobs(None)
    eng = build_engine(serve.cfg, serve.tenants, "cpu", serve.seed)
    want = serve_runs(eng, serve)["run"]
    (ref,) = run(rounds)
    res = sorted(ranks["package", "1x1x2", "dbrx-smoke"],
                 key=lambda r: r["coord"]["model"])
    served = [r["tasks"][0]["run"] for r in res]
    for s in served:
        _equal(s["streams"], want["streams"])
    ids = [s["first_chunk_routing"]["ids"] for s in served]
    assert len(ids[0]) == _package_cfg().n_layers
    assert all(torch.equal(a, b) for a, b in zip(*ids))
    for a, b in zip(ids[0], want["first_chunk_routing"]["ids"]):
        assert torch.equal(a, b)
    cases = [r["tasks"][1][0][0] for r in res]
    theta = _gather(adapter_specs(_package_cfg()),
                    [c["theta"] for c in cases])
    for (p, g), (_, w) in zip(tree_leaves(theta), tree_leaves(ref["theta"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=p)
    for c in cases:
        assert c["loss"][0] == pytest.approx(ref["loss"][0], rel=REL_TOL,
                                             abs=1e-6)
        assert c["aux_loss"] == pytest.approx(ref["aux_loss"], rel=REL_TOL)
        assert c["objective"] == pytest.approx(ref["objective"], rel=REL_TOL)
        assert c["aux_loss"] > 0

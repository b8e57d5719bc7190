"""The FDLoRA round on a mesh of CPU ranks against the meshless round and
the reference, on ``tiny_dense`` in fp32.

One spawn per world size (``launch/mesh.spawn``: gloo, one torch thread
a rank), every case of that world inside it (``federated/mesh_job.run``):

* world 2, pod 2: θ_s', every client's state, the outer state and the
  loss bitwise equal to the port's meshless round from the same θ_s,
  state and batches, under ``compress_outer`` "none" and "bf16", with
  ``sync_personalized`` on and off;
* four clients under ``compress_outer="bf16"``: world 2, pod 2 (two
  clients a rank, their bf16 pseudo-gradients summed in fp32 before the
  wire), world 2, data 2 (all four clients on each rank, each on half
  the rows) and world 4, pod 2 × data 2: within ``leaf_tol`` of the
  reference's ``make_fdlora_round_step`` on the whole batch (fp32 sums
  in another order, the bf16 mean rounded at each rank's share and at
  the sum; the masks differ row to row, so the global token mean
  matters);
* two clients in fp32 at data 2 and at pod 2 × data 2: within
  ``leaf_tol`` of the port's meshless round (itself held to the
  reference by ``tests/test_torch_distributed.py``);
* on every rank: θ_s' the same, and the adapters the same within a data
  group; the collective log holds one pod all-reduce a round, of the
  adapter tree's bytes and the loss slots, and K + 1 data all-reduces at
  data 2 (none at data 1).

World 1 runs in this process (a one-rank gloo group over a HashStore).
The refusals (an expert or kv-head count that does not divide at a
"model" axis > 1; an MoE model's data-parallel gradient without its data
group) come at construction and need no ranks.  Last, the torch
multipod example on 2 CPU ranks.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import tiny_dense, tiny_moe
from repro.core.lora import init_adapters as j_init_adapters
from repro.core.outer_opt import make_outer_optimizer as j_outer_opt
from repro.federated import distributed as j_dist
from repro.models.api import get_model
from repro.training import optimizers as j_opt
from repro_torch import bridge
from repro_torch.core.lora import tree_leaves
from repro_torch.core.outer_opt import make_outer_optimizer
from repro_torch.federated import distributed
from repro_torch.federated.mesh_job import Case, RoundJob, run, run_jobs
from repro_torch.launch.mesh import spawn
from repro_torch.models.api import Model
from repro_torch.training import optimizers
from test_torch_distributed import leaf_tol

N, K, B, S = 2, 2, 2, 16
INNER_LR, OUTER_LR, MOMENTUM = 1e-3, 0.5, 0.5
ROUNDS = 2
LOSS_TOL = 1e-5          # as tests/test_torch_distributed.py

POD2 = [Case(pod=2, compress=c, sync=s) for c in ("none", "bf16")
        for s in (False, True)]
DATA2 = [Case(pod=1, data=2, sync=True)]
GRID = [Case(pod=2, data=2, sync=True)]
# four clients, bf16 pseudo-gradients: against the reference
N4 = 4
POD2_4, DATA2_4, GRID_4 = (Case(pod=p, data=d, compress="bf16", sync=True)
                           for p, d in ((2, 1), (1, 2), (2, 2)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    running = dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if not running and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    theta = jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        j_init_adapters(jax.random.PRNGKey(1), jcfg))

    def batches(n, seed):
        out = []
        for r in range(ROUNDS):
            rng = np.random.default_rng(seed + r)
            out.append({
                "tokens": rng.integers(0, jcfg.vocab_size,
                                       (n, K, B, S)).astype(np.int32),
                "loss_mask": (rng.random((n, K, B, S)) < 0.7
                              ).astype(np.int32)})
        return out

    batches4 = batches(N4, 20)
    job = RoundJob(pcfg, [], clients=N, inner_steps=K, rows=B, seq=S,
                   rounds=ROUNDS, inner_lr=INNER_LR, outer_lr=OUTER_LR,
                   outer_momentum=MOMENTUM, params=pp,
                   theta=bridge.adapters_from_jax(theta, device="cpu"),
                   batches=batches(N, 10), device="cpu")
    job4 = RoundJob(**{**job.__dict__, "clients": N4, "batches": batches4})
    return jcfg, jm, jp, theta, batches4, job, job4


def _job(job, cases):
    return RoundJob(**{**job.__dict__, "cases": cases})


def _spawn(world, jobs):
    """Every job on ``world`` ranks in one spawn; per rank, the results
    of every case of every job in one list."""
    ranks = spawn(run_jobs, world, jobs, device="cpu")
    return [[r for res in rank for r in res] for rank in ranks]


@pytest.fixture(scope="module")
def meshless(setup):
    """The port's meshless round, case by case, keyed by (compress, sync)."""
    job = setup[5]
    keys = sorted({(c.compress, c.sync) for c in POD2 + DATA2 + GRID})
    out = run(_job(job, [Case(pod=None, compress=c, sync=s)
                         for c, s in keys]))
    return dict(zip(keys, out))


@pytest.fixture(scope="module")
def world2(setup):
    return _spawn(2, [_job(setup[5], POD2 + DATA2),
                      _job(setup[6], [POD2_4, DATA2_4])])


@pytest.fixture(scope="module")
def world4(setup):
    return _spawn(4, [_job(setup[5], GRID), _job(setup[6], [GRID_4])])


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's round on the four clients' batches
    (``sync_personalized`` on, bf16 pseudo-gradients): per round (θ_s',
    state, loss)."""
    jcfg, jm, jp, theta, batches = setup[:5]
    inner = j_opt.adamw(lr=INNER_LR)
    outer = j_outer_opt("nesterov", lr=OUTER_LR, momentum=MOMENTUM)
    step = jax.jit(j_dist.make_fdlora_round_step(
        jm, jcfg, inner, outer, K, sync_personalized=True,
        compress_outer="bf16"))
    th = jax.tree.map(jnp.asarray, theta)
    st = {"inner_opt": jax.tree.map(lambda x: jnp.stack([x] * N4),
                                    inner.init(th)),
          "outer_opt": outer.init(th)}
    rounds = []
    for b in batches:
        th, st, loss = step(jp, th, st, jax.tree.map(jnp.asarray, b))
        rounds.append((th, st, float(loss)))
    return rounds


def _results(ranks, case, clients=N):
    return [next(r for r in res if r["case"]["pod"] == case.pod
                 and r["case"]["data"] == case.data
                 and r["case"]["compress"] == case.compress
                 and r["case"]["sync"] == case.sync
                 and r["clients"] == clients) for res in ranks]


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert np.array_equal(x, y), path


@pytest.mark.parametrize("case", POD2, ids=[
    f"{c.compress}-{'sync' if c.sync else 'nosync'}" for c in POD2])
def test_pod2_is_bitwise_the_meshless_round(world2, meshless, case):
    ref = meshless[(case.compress, case.sync)]
    ranks = sorted(_results(world2, case), key=lambda r: r["coord"]["pod"])
    for r in ranks:
        assert r["loss"] == ref["loss"]
        assert r["digest"] == ref["digest"]
        _equal(r["theta"], ref["theta"])
        _equal(r["state"]["outer_opt"], ref["state"]["outer_opt"])
        assert ("personalized" in r["state"]) == case.sync
    # rank p holds client p: its inner state (and personalized tree)
    assert [d for r in ranks for d in r["client_digests"]] == \
        ref["client_digests"]
    for p, r in enumerate(ranks):
        _equal(distributed.client_slice(r["state"]["inner_opt"], 0),
               distributed.client_slice(ref["state"]["inner_opt"], p))


def _close(got, want, atol):
    """Port trees ``got`` and ``want`` leaf for leaf within ``atol`` (and
    1e-4 of the value)."""
    got, exp = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == exp.keys()
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), exp[path].numpy(),
                                   atol=atol, rtol=1e-4, err_msg=path)


def _port(jtree):
    return bridge.adapters_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def _held_to(ranks, case, clients, rounds, personalized, theta_tol=0.0):
    """Every rank's losses, θ_s' and personalized trees against
    ``rounds`` (per round: θ_s', loss) and ``personalized(i)`` (client
    i's tree after the last round); θ_s' within ``theta_tol`` more."""
    n_local = clients // case.pod
    # the inner leaves' noise, carried by the outer step (lr·(1 + μ) ≤ 1)
    tol = leaf_tol(INNER_LR, ROUNDS * K)
    for r in ranks:
        first = r["coord"]["pod"] * n_local
        for got, (_, want) in zip(r["loss"], rounds):
            assert got == pytest.approx(want, abs=LOSS_TOL)
        _close(r["theta"], rounds[-1][0], tol + theta_tol)
        for i in range(n_local):
            _close(distributed.client_slice(r["state"]["personalized"], i),
                   personalized(first + i), tol)
            assert int(r["state"]["inner_opt"]["count"][i]) == ROUNDS * K


def _held_to_reference(ranks, case, reference):
    """The bf16 pseudo-gradients' part of θ_s''s tolerance is
    ``tests/test_torch_distributed.py``'s: each client's value and their
    mean may round to a neighbouring bf16 value when the packages' fp32
    inputs differ in the last bits, one spacing (2^-7 of the value)
    each, 2^-6 of the largest pseudo-gradient in all.  At pod > 1 each
    rank's share of the mean is rounded too, half a spacing (2^-8) of a
    share, whose sizes add up to at most the largest pseudo-gradient.
    Times the last outer step's lr·(1 + μ)."""
    jprev, jst = reference[-2][0], reference[-1][1]
    delta = max(float(np.abs(np.asarray(a)[None] - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(jprev),
                                jax.tree.leaves(jst["personalized"])))
    bf16 = OUTER_LR * (1 + MOMENTUM) * delta * (
        2.0 ** -6 + (2.0 ** -8 if case.pod > 1 else 0.0))
    _held_to(ranks, case, N4, [(_port(th), l) for th, _, l in reference],
             lambda i: _port(jax.tree.map(lambda x: np.asarray(x)[i],
                                          jst["personalized"])), bf16)


@pytest.mark.parametrize("grid,case", [("world2", DATA2_4),
                                       ("world4", GRID_4)],
                         ids=["data2", "pod2xdata2"])
def test_data_parallel_round_matches_reference(request, reference, grid,
                                               case):
    _held_to_reference(_results(request.getfixturevalue(grid), case, N4),
                       case, reference)


def test_pod2_four_clients_bf16_matches_reference(world2, reference):
    """Two clients a rank: their bf16 pseudo-gradients summed in fp32,
    over the client count, cast to bf16 once for the wire."""
    _held_to_reference(_results(world2, POD2_4, N4), POD2_4, reference)


@pytest.mark.parametrize("grid,case", [("world2", DATA2[0]),
                                       ("world4", GRID[0])],
                         ids=["data2", "pod2xdata2"])
def test_data_parallel_fp32_round_matches_meshless(request, meshless, grid,
                                                   case):
    ref = meshless[(case.compress, case.sync)]
    _held_to(_results(request.getfixturevalue(grid), case), case, N,
             list(zip([ref["theta"]] * ROUNDS, ref["loss"])),
             lambda i: distributed.client_slice(
                 ref["state"]["personalized"], i))


@pytest.mark.parametrize("grid", ["world2", "world4"])
def test_ranks_agree(request, grid):
    ranks = request.getfixturevalue(grid)
    for c in range(len(ranks[0])):
        cases = [res[c] for res in ranks]
        assert len({r["digest"] for r in cases}) == 1
        assert len({r["outer_digest"] for r in cases}) == 1
        assert len({tuple(r["loss"]) for r in cases}) == 1
        by_pod = {}
        for r in cases:     # a data group: the ranks of one pod coordinate
            by_pod.setdefault(r["coord"]["pod"], set()).add(
                tuple(r["client_digests"]))
        assert all(len(v) == 1 for v in by_pod.values())


@pytest.mark.parametrize("grid", ["world2", "world4"])
def test_collective_log(request, setup, grid):
    lora = setup[5].cfg.count_lora_params()
    for res in request.getfixturevalue(grid):
        for r in res:
            case = r["case"]
            for log in r["collectives"]:
                pod = [c for c in log if c["axis"] == "pod"]
                data = [c for c in log if c["axis"] == "data"]
                assert len(pod) == 1 and len(pod) + len(data) == len(log)
                (c,) = pod
                assert c["op"] == "all-reduce" and c["group"] == case["pod"]
                # the adapter tree (fp32, or bf16) and a loss slot a
                # client (fp32, or four bf16 bytes)
                n = r["clients"]
                assert c["bytes"] == (lora * 2 + n * 8 if case["compress"]
                                      == "bf16" else lora * 4 + n * 4)
                assert c["per_card_bytes"] == 2 * c["bytes"] * (
                    case["pod"] - 1) / case["pod"]
                assert len(data) == (K + 1 if case["data"] > 1 else 0)
                assert all(d["group"] == case["data"] for d in data)


def test_world_one_in_process_is_bitwise_the_meshless_round(setup, meshless):
    """A one-rank gloo group over a HashStore, started by the mesh
    factory; the pod all-reduce still runs, on one rank."""
    cases = [Case(pod=1, compress=c, sync=True) for c in ("none", "bf16")]
    for case, r in zip(cases, run(_job(setup[5], cases))):
        ref = meshless[(case.compress, True)]
        assert r["loss"] == ref["loss"] and r["digest"] == ref["digest"]
        assert r["client_digests"] == ref["client_digests"]
        assert [len(log) for log in r["collectives"]] == [1] * ROUNDS


def test_refusals():
    pcfg = bridge.config_from_jax(tiny_dense())
    inner, outer = optimizers.adamw(), make_outer_optimizer("nesterov")
    model = Model(pcfg, device="cpu")
    with pytest.raises(ValueError, match='"pod" axis'):
        distributed.make_fdlora_round_step(
            model, pcfg, inner, outer, K, mesh={"data": 1, "model": 1})
    # the "model" axis splits dense and MoE configs whose counts divide:
    # an expert count and a kv-head count that do not divide stay refused
    moe3 = bridge.config_from_jax(tiny_moe()).with_overrides(n_experts=3)
    with pytest.raises(ValueError, match="n_experts 3 does not divide"):
        distributed.make_fdlora_round_step(
            Model(moe3, device="cpu"), moe3, inner, outer, K,
            mesh={"pod": 1, "data": 1, "model": 2})
    mqa = bridge.config_from_jax(tiny_dense(n_kv_heads=1))
    with pytest.raises(ValueError, match="n_kv_heads 1 does not divide"):
        distributed.make_fdlora_round_step(
            Model(mqa, device="cpu"), mqa, inner, outer, K,
            mesh={"pod": 1, "data": 1, "model": 2})
    # the data-parallel gradient of an MoE model needs the data group
    from repro_torch.training.train_step import data_parallel_value_and_grad
    moe = bridge.config_from_jax(tiny_moe())
    with pytest.raises(ValueError, match="need its data group"):
        data_parallel_value_and_grad(Model(moe, device="cpu"), moe,
                                     lambda t: t)
    # experts at data 1, data 2 and model 2 are fine: the round's
    # construction goes through
    from repro_torch.launch.dryrun import RankMesh
    for mesh in ({"pod": 2, "data": 1, "model": 1}, RankMesh((1, 2, 2))):
        distributed.make_fdlora_round_step(
            Model(moe, device="cpu"), moe, inner, outer, K, mesh=mesh)


def test_torch_multipod_example_runs_on_the_cpu():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_multipod_federated.py"
    spec = importlib.util.spec_from_file_location("torch_mp_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert np.isfinite(out["loss"]) and len(set(out["digests"])) == 1
    (c,) = out["collectives"]
    assert c["axis"] == "pod" and c["bytes"] == out["adapter_bytes"] + 2 * 4

"""The port's client-stacked FDLoRA round step against the reference's on
the CPU.

``make_fdlora_round_step`` of both packages runs two rounds from the same
θ_s (B non-zero), the same stacked AdamW state and the same (N, K, B, S)
batches on ``tiny_dense`` in fp32: θ_s', the stacked inner state, the outer
state and the loss agree, under the Nesterov outer step, ``fedavg`` (which
also ends at the client mean, as ``tests/test_distributed.py`` checks),
``compress_outer="bf16"`` and ``sync_personalized=True``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.core.outer_opt import make_outer_optimizer as j_outer_opt
from repro.federated import distributed as j_dist
from repro.models.api import get_model
from repro.training import optimizers as j_opt
from repro_torch import bridge
from repro_torch.core.lora import tree_leaves, tree_map, tree_mean
from repro_torch.core.outer_opt import make_outer_optimizer
from repro_torch.federated import distributed
from repro_torch.models.api import Model
from repro_torch.training import optimizers
from repro_torch.training.train_step import make_lora_train_step

# fp32 on both sides from the same inputs: only summation order differs
# (copied from tests/test_torch_training.py)
LOSS_TOL = 1e-5


def leaf_tol(lr: float, steps: int) -> float:
    """Adapters after AdamW steps: Adam divides by sqrt(v) + eps, so a
    gradient element not far above eps carries its fp32 summation noise
    into an update of up to lr in size; 1e-2 of lr per step bounds it."""
    return 1e-2 * lr * steps


N, K, B, S = 2, 2, 2, 16
INNER_LR, OUTER_LR, MOMENTUM = 1e-3, 0.5, 0.5
ROUNDS = 2


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tmpl = j_init_adapters(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(3)
    theta = jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)
    batches = []
    for r in range(ROUNDS):
        rng = np.random.default_rng(10 + r)
        batches.append({
            "tokens": rng.integers(0, jcfg.vocab_size,
                                   (N, K, B, S)).astype(np.int32),
            "loss_mask": (rng.random((N, K, B, S)) < 0.7).astype(np.int32)})
    return jcfg, jm, jp, pcfg, pm, pp, theta, batches


def _client(jtree, i):
    """Client i of a reference tree stacked on the client axis, bridged."""
    return bridge.adapters_from_jax(
        jax.tree.map(lambda x: np.asarray(x)[i], jtree), device="cpu")


def _assert_close(port, want, atol):
    got, exp = dict(tree_leaves(port)), dict(tree_leaves(want))
    assert got.keys() == exp.keys()
    for path in got:
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   exp[path].numpy(), atol=atol, rtol=1e-4,
                                   err_msg=path)


def _run_both(setup, outer_kind, compress, sync):
    jcfg, jm, jp, pcfg, pm, pp, theta, batches = setup
    j_inner, p_inner = (j_opt.adamw(lr=INNER_LR),
                        optimizers.adamw(lr=INNER_LR))
    j_outer = j_outer_opt(outer_kind, lr=OUTER_LR, momentum=MOMENTUM)
    p_outer = make_outer_optimizer(outer_kind, lr=OUTER_LR, momentum=MOMENTUM)
    jround = jax.jit(j_dist.make_fdlora_round_step(
        jm, jcfg, j_inner, j_outer, K, sync_personalized=sync,
        compress_outer=compress))
    pround = distributed.make_fdlora_round_step(
        pm, pcfg, p_inner, p_outer, K, sync_personalized=sync,
        compress_outer=compress)
    jth = jax.tree.map(jnp.asarray, theta)
    pth = bridge.adapters_from_jax(theta, device="cpu")
    jst = {"inner_opt": jax.tree.map(lambda x: jnp.stack([x] * N),
                                     j_inner.init(jth)),
           "outer_opt": j_outer.init(jth)}
    pst = {"inner_opt": distributed.stack_clients([p_inner.init(pth)] * N),
           "outer_opt": p_outer.init(pth)}
    out = []
    for b in batches:
        jth_prev, pth_prev = jth, pth
        jth, jst, jl = jround(jp, jth, jst, jax.tree.map(jnp.asarray, b))
        pth, pst, pl = pround(pp, pth, pst,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((jth_prev, pth_prev, jth, jst, jl, pth, pst, pl))
    return out


def _theta_tol(rounds, compress, j_prev, j_state):
    """θ_s' after ``rounds`` rounds of K inner steps: the inner leaves'
    noise (``leaf_tol``) carried by the outer step (lr · (1 + momentum)
    ≤ 1 here).  bf16: each client's pseudo-gradient element and their
    mean may round to a neighbouring bf16 value when the packages' fp32
    inputs differ in the last bits, one bf16 spacing (2^-7 of the value:
    8 significant bits) each, so the mean moves by at most 2^-6 of the
    largest pseudo-gradient, times the outer step's lr · (1 + momentum)."""
    tol = leaf_tol(INNER_LR, rounds * K)
    if compress == "bf16":
        delta = max(float(np.abs(np.asarray(a)[None] - np.asarray(b)).max())
                    for a, b in zip(jax.tree.leaves(j_prev),
                                    jax.tree.leaves(j_state["personalized"])))
        tol += OUTER_LR * (1 + MOMENTUM) * 2.0 ** -6 * delta
    return tol


@pytest.mark.parametrize("outer_kind,compress,sync", [
    ("nesterov", "none", False),
    ("fedavg", "none", False),
    ("nesterov", "bf16", True),
    ("nesterov", "none", True),
], ids=["nesterov", "fedavg", "bf16", "sync_personalized"])
def test_round_step_matches_reference(setup, outer_kind, compress, sync):
    rounds = _run_both(setup, outer_kind, compress, sync)
    for r, (jprev, pprev, jth, jst, jl, pth, pst, pl) in enumerate(rounds, 1):
        assert float(pl) == pytest.approx(float(jl), abs=LOSS_TOL)
        tol_inner = leaf_tol(INNER_LR, r * K)
        _assert_close(pth, bridge.adapters_from_jax(
            jax.tree.map(np.asarray, jth), "cpu"),
            _theta_tol(r, compress, jprev, jst) if sync else tol_inner)
        # the stacked inner AdamW state, client by client
        assert list(pst["inner_opt"]["count"]) == \
            list(np.asarray(jst["inner_opt"]["count"])) == [r * K] * N
        for i in range(N):
            for key in ("mu", "nu"):
                _assert_close(
                    distributed.client_slice(pst["inner_opt"][key], i),
                    _client(jst["inner_opt"][key], i), tol_inner)
            assert pst["inner_opt"]["mu"]["layers"][0]["mixer"]["wq"][
                "a"].shape[0] == N
        if outer_kind == "nesterov":
            _assert_close(pst["outer_opt"]["v"], bridge.adapters_from_jax(
                jax.tree.map(np.asarray, jst["outer_opt"]["v"]), "cpu"),
                tol_inner)
        assert ("personalized" in pst) == sync
        if sync:
            for i in range(N):
                _assert_close(distributed.client_slice(pst["personalized"], i),
                              _client(jst["personalized"], i), tol_inner)
        if compress == "bf16" and r == 1:
            # the port's own arithmetic, exactly: the first Nesterov step
            # (velocity from zero) moves θ_s by lr·(1 + momentum) times the
            # bf16 mean of the bf16 pseudo-gradients
            want = tree_map(
                lambda prev, ti: prev - OUTER_LR * (1 + MOMENTUM) * (
                    (prev[None] - ti).to(torch.bfloat16).mean(0).float()),
                pprev, pst["personalized"])
            _assert_close(pth, want, atol=1e-7)


def test_fedavg_round_ends_at_the_client_mean(setup):
    """With OuterOpt = SGD(lr=1) one round is the mean of the clients'
    own K steps from θ_s, run by hand through the train step."""
    jcfg, jm, jp, pcfg, pm, pp, theta, batches = setup
    inner = optimizers.adamw(lr=INNER_LR)
    outer = make_outer_optimizer("fedavg")
    pth = bridge.adapters_from_jax(theta, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    state = {"inner_opt": distributed.stack_clients([inner.init(pth)] * N),
             "outer_opt": outer.init(pth)}
    new, _, loss = distributed.make_fdlora_round_step(
        pm, pcfg, inner, outer, K)(pp, pth, state, tb)
    step = make_lora_train_step(pm, pcfg, inner)
    outs, losses = [], []
    for i in range(N):
        ad, st = pth, inner.init(pth)
        for k in range(K):
            ad, st, m = step(pp, ad, st, {n: v[i, k] for n, v in tb.items()})
            losses.append(float(m["loss"]))
        outs.append(ad)
    _assert_close(new, tree_mean(outs), atol=2e-7)
    assert float(loss) == pytest.approx(np.mean(losses), abs=1e-6)


def test_stack_clients_round_trips():
    inner = optimizers.adamw()
    tree = {"x": [{"a": torch.arange(6.0).reshape(2, 3)}]}
    st = [inner.init(tree), inner.init(tree)]
    st[1] = dict(st[1], count=3)
    stacked = distributed.stack_clients(st)
    assert stacked["mu"]["x"][0]["a"].shape == (2, 2, 3)
    assert list(stacked["count"]) == [0, 3]
    back = distributed.client_slice(stacked, 1)
    assert back["count"] == 3 and isinstance(back["count"], int)
    with pytest.raises(ValueError, match="compress_outer"):
        distributed.make_fdlora_round_step(None, None, inner, inner, 1,
                                           compress_outer="int8")

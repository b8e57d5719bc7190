"""Activation recomputation (``ModelConfig.remat``, ``remat_policy``)
against the JAX package, on the CPU.

The reference wraps each period of layers of a train step's forward in
``jax.checkpoint`` (``"dots"``: ``dots_with_no_batch_dims_saveable``); the
port runs each period under ``torch.utils.checkpoint`` (``"dots"``: a
selective-checkpoint policy saving ``aten.mm``/``addmm`` and the LoRA
kernel's operator).  Recomputation changes what a step keeps, never what
it computes:

* the LoRA loss and every adapter gradient at remat off, ``"full"`` and
  ``"dots"`` are bitwise equal to each other, and each is within the
  training tests' tolerance of the reference's ``jax.value_and_grad`` at
  the same setting, on tiny_dense, dbrx-smoke (MoE), jamba-smoke (one
  period of 4 layers) and internvl2-smoke (a VLM's patches), fp32;
* one full fine-tuning step's new weights are bitwise equal at each
  setting;
* it happens: ``"full"`` issues more ``aten.mm`` in backward than off,
  ``"dots"`` exactly as many (the products are saved); one checkpoint a
  period (jamba: one for its 4 layers), each run once forward and once
  in backward; no checkpoint under ``no_grad`` or in the
  encoder-decoder;
* a pinned ``moe.RoutingLog`` keeps its pins through a recomputed period
  (the gradients of the pinned step at off) and logs one forward;
* two gloo ranks at model 2: the gradients at ``"full"`` and ``"dots"``
  bitwise off's, the collective log equal to the dry run's walk;
* the dry run accepts ``no_remat``, ``remat_dots`` and ``opt_moe``; on
  llama2-7b ``train_4k`` its peaks order baseline < remat_dots <
  no_remat; at ``"full"`` each added period adds one (B, S, d) boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_remat_ranks
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import tiny_dense
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import init_adapters, tree_leaves, tree_map
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.training.optimizers import adamw
from repro_torch.training.train_step import (lora_value_and_grad,
                                             make_eval_fn,
                                             make_full_train_step,
                                             make_lora_loss_fn)

# the training tests' tolerances: fp32 on both sides, only the order of
# summation differs
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
SETTINGS = {"off": {"remat": False},
            "full": {"remat": True, "remat_policy": "full"},
            "dots": {"remat": True, "remat_policy": "dots"}}
CASES = {"tiny_dense": lambda: tiny_dense(),
         "dbrx-smoke": lambda: j_get_config("dbrx-132b", smoke=True),
         "jamba-smoke": lambda: j_get_config("jamba-v0.1-52b", smoke=True),
         "internvl2-smoke": lambda: j_get_config("internvl2-26b",
                                                 smoke=True)}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops throughout: one intra-op thread for this file (the
    suite's workers share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(name, setting):
    return CASES[name]().with_overrides(dtype="float32",
                                        param_dtype="float32",
                                        **SETTINGS[setting])


def _batch(jcfg, seed=2):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.7).astype(np.int32)}
    if jcfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    return b


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def inputs():
    """name -> (reference params, port params, adapters with a non-zero B
    (reference layout), batch), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = _jcfg(name, "off")
            jp = jax.jit(get_model(jcfg).init)(jax.random.PRNGKey(0))
            rng = np.random.default_rng(1)
            ad = jax.tree.map(
                lambda l: (rng.standard_normal(l.shape) * 0.1).astype(
                    np.float32), j_init_adapters(jax.random.PRNGKey(0), jcfg))
            cache[name] = (jp, bridge.params_from_jax(_np(jp), device="cpu"),
                           ad, _batch(jcfg))
        return cache[name]
    return get


_PORT, _REF = {}, {}


def _port_grads(inputs, name, setting):
    """(loss, {path: gradient}) of the port's LoRA loss at ``setting``."""
    if (name, setting) not in _PORT:
        _, pp, ad, batch = inputs(name)
        pcfg = bridge.config_from_jax(_jcfg(name, setting))
        loss, _, grads = lora_value_and_grad(Model(pcfg, "cpu"), pcfg)(
            pp, bridge.adapters_from_jax(ad, device="cpu"), _tb(batch))
        _PORT[name, setting] = (loss, dict(tree_leaves(grads)))
    return _PORT[name, setting]


def test_bridged_config_carries_the_reference_setting():
    for name in CASES:
        for setting, kw in SETTINGS.items():
            jcfg = _jcfg(name, setting)
            pcfg = bridge.config_from_jax(jcfg)
            assert (pcfg.remat, pcfg.remat_policy) == (jcfg.remat,
                                                       jcfg.remat_policy)
    # the reference's defaults, in the port's own configs too
    assert (get_config("llama2-7b").remat,
            get_config("llama2-7b").remat_policy) == (True, "full")
    with pytest.raises(ValueError, match="remat_policy"):
        get_config("llama2-7b").with_overrides(remat_policy="offload")


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_are_bitwise_equal_at_every_setting(inputs, name):
    loss, grads = _port_grads(inputs, name, "off")
    for setting in ("full", "dots"):
        l2, g2 = _port_grads(inputs, name, setting)
        assert torch.equal(l2, loss), setting
        assert g2.keys() == grads.keys()
        for path, g in grads.items():
            assert torch.equal(g2[path], g), (setting, path)


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_reference_at_each_setting(inputs, name,
                                                            setting):
    jp, _, ad, batch = inputs(name)
    jcfg = _jcfg(name, setting)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        j_ts.make_lora_loss_fn(get_model(jcfg), jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, ad), jp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = _port_grads(inputs, name, setting)
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
    want = dict(tree_leaves(bridge.adapters_from_jax(_np(jg), device="cpu")))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("setting", ["full", "dots"])
def test_full_train_step_weights_are_bitwise_off_s(inputs, setting):
    _, pp, _, batch = inputs("tiny_dense")
    out = {}
    for s in ("off", setting):
        pcfg = bridge.config_from_jax(_jcfg("tiny_dense", s))
        opt = adamw(lr=1e-2)
        step = make_full_train_step(Model(pcfg, "cpu"), pcfg, opt)
        out[s] = dict(tree_leaves(step(pp, opt.init(pp), _tb(batch))[0]))
    for path, w in out["off"].items():
        assert torch.equal(out[setting][path], w), path


class MmInBackward(TorchDispatchMode):
    """Counts ``aten.mm`` while ``on``."""

    def __init__(self):
        super().__init__()
        self.on, self.mm = False, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.on and func._overloadpacket is torch.ops.aten.mm:
            self.mm += 1
        return func(*args, **(kwargs or {}))


class Checkpoints:
    """Counts the periods ``models/model.py`` checkpoints and the calls
    of each period's function (its forward and its recomputations)."""

    def __init__(self, monkeypatch):
        self.periods, self.calls = 0, 0
        orig = model_lib.checkpoint

        def counted(fn, *args, **kw):
            self.periods += 1

            def run(*a):
                self.calls += 1
                return fn(*a)
            return orig(run, *args, **kw)
        monkeypatch.setattr(model_lib, "checkpoint", counted)


def _loss_and_leaves(name, setting, inputs):
    """The port's config at ``setting``, its LoRA loss (forward only) and
    the adapter leaves it is a function of."""
    _, pp, ad, batch = inputs(name)
    pcfg = bridge.config_from_jax(_jcfg(name, setting))
    leaves = []

    def leaf(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]
    tree = tree_map(leaf, bridge.adapters_from_jax(ad, device="cpu"))
    loss, _ = make_lora_loss_fn(Model(pcfg, "cpu"), pcfg)(tree, pp,
                                                          _tb(batch))
    return pcfg, loss, leaves


@pytest.mark.parametrize("name", ["tiny_dense", "jamba-smoke"])
def test_recomputation_happens_once_a_period(inputs, name, monkeypatch):
    mm, periods = {}, {}
    for setting in SETTINGS:
        ck = Checkpoints(monkeypatch)
        pcfg, loss, leaves = _loss_and_leaves(name, setting, inputs)
        n_periods = pcfg.n_layers // len(pcfg.layer_pattern)
        assert ck.periods == (n_periods if pcfg.remat else 0)
        assert ck.calls == ck.periods                 # forward only so far
        counter = MmInBackward()
        with counter:
            counter.on = True
            torch.autograd.grad(loss, leaves)
        # each period once more, in backward
        assert ck.calls == 2 * ck.periods
        mm[setting], periods[setting] = counter.mm, ck.periods
    if name == "jamba-smoke":
        assert periods["full"] == 1                   # 4 layers, 1 period
    assert mm["full"] > mm["off"]
    assert mm["dots"] == mm["off"]


def test_no_recomputation_without_grad_or_in_the_encoder_decoder(
        inputs, monkeypatch):
    ck = Checkpoints(monkeypatch)
    _, pp, ad, batch = inputs("tiny_dense")
    pcfg = bridge.config_from_jax(_jcfg("tiny_dense", "full"))
    model = Model(pcfg, "cpu")
    make_eval_fn(model, pcfg)(pp, bridge.adapters_from_jax(ad, device="cpu"),
                              _tb(batch))
    with torch.no_grad():
        model.forward(pp, _tb(batch))
    assert ck.periods == 0
    ecfg = get_config("whisper-small", smoke=True).with_overrides(
        dtype="float32", param_dtype="float32")
    assert ecfg.remat
    em = Model(ecfg, "cpu")
    rng = np.random.default_rng(3)
    eb = _tb(_batch(ecfg))
    eb["enc_embeds"] = torch.from_numpy(rng.standard_normal(
        (B, ecfg.encoder_seq_len, ecfg.d_model)).astype(np.float32))
    lora_value_and_grad(em, ecfg)(em.init(0), init_adapters(ecfg,
                                                            device="cpu"),
                                  eb)
    assert ck.periods == 0


@pytest.mark.parametrize("setting", ["full", "dots"])
def test_pinned_routing_survives_recomputation(inputs, setting):
    """dbrx-smoke pinned to ids unlike its own (each top-k set rolled by
    one expert): the pinned step at ``setting`` gives off's pinned
    gradients bitwise, and its log holds one forward's routing calls."""
    _, pp, ad, batch = inputs("dbrx-smoke")
    out = {}
    for s in ("off", setting):
        pcfg = bridge.config_from_jax(_jcfg("dbrx-smoke", s))
        vg = lora_value_and_grad(Model(pcfg, "cpu"), pcfg)
        with moe.RoutingLog() as own:
            vg(pp, bridge.adapters_from_jax(ad, device="cpu"), _tb(batch))
        pins = [(i + 1) % pcfg.n_experts for i in own.ids]
        with moe.RoutingLog(pinned=pins) as log:
            loss, _, grads = vg(pp, bridge.adapters_from_jax(ad,
                                                             device="cpu"),
                                _tb(batch))
        # one forward's routing calls and dispatches, nothing of the
        # recomputed one
        assert len(own.ids) == len(log.ids) == pcfg.n_layers
        assert len(log.dispatched) == len(log.keep) == pcfg.n_layers
        for pin, got in zip(pins, log.dispatched):
            assert torch.equal(pin, got)
        assert not moe._OPEN_LOGS
        out[s] = (loss, dict(tree_leaves(grads)), own, log)
    assert torch.equal(out[setting][0], out["off"][0])
    for path, g in out["off"][1].items():
        assert torch.equal(out[setting][1][path], g), path
    for i in (2, 3):          # the logs at off and at the setting alike
        for field in ("ids", "logits", "keep"):
            for want, got in zip(getattr(out["off"][i], field),
                                 getattr(out[setting][i], field)):
                assert torch.equal(want, got), field
    # the pins moved the loss: a recompute routing by its own logits shows
    _, pp, ad, batch = inputs("dbrx-smoke")
    pcfg = bridge.config_from_jax(_jcfg("dbrx-smoke", "off"))
    free, _, _ = lora_value_and_grad(Model(pcfg, "cpu"), pcfg)(
        pp, bridge.adapters_from_jax(ad, device="cpu"), _tb(batch))
    assert not torch.equal(free, out["off"][0])


def test_a_pin_closed_before_its_backward_raises(inputs):
    _, pp, ad, batch = inputs("dbrx-smoke")
    pcfg = bridge.config_from_jax(_jcfg("dbrx-smoke", "full"))
    leaves = []

    def leaf(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]
    tree = tree_map(leaf, bridge.adapters_from_jax(ad, device="cpu"))
    with moe.RoutingLog() as own:
        Model(pcfg, "cpu").forward(pp, _tb(batch), tree, 2.0)
    with moe.RoutingLog(pinned=own.ids):
        logits, _ = Model(pcfg, "cpu").forward(pp, _tb(batch), tree, 2.0)
    with pytest.raises(RuntimeError, match="closed before"):
        torch.autograd.grad(logits.sum(), leaves)


@pytest.fixture(scope="module")
def model2():
    cfgs = {s: bridge.config_from_jax(_jcfg("tiny_dense", s))
            for s in SETTINGS}
    params = Model(cfgs["off"], "cpu").init(3)
    ad = init_adapters(cfgs["off"], seed=4, device="cpu", b_std=0.1)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 300, (B, S)).astype(np.int32)),
        "loss_mask": torch.from_numpy(
            (rng.random((B, S)) < 0.7).astype(np.int32))}
    ranks = spawn(torch_remat_ranks.model2_steps, 2, cfgs, params, ad, batch,
                  device="cpu")
    return cfgs, sorted(ranks, key=lambda r: r["model"])


def _by_axis(log):
    out = {}
    for c in log:
        key = (c["axis"], c["group"], c["bytes"])
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("setting", ["full", "dots"])
def test_model_axis_gradients_are_bitwise_off_s(model2, setting):
    for rank in model2[1]:
        assert torch.equal(rank[setting]["loss"], rank["off"]["loss"])
        got = dict(tree_leaves(rank[setting]["grads"]))
        for path, g in tree_leaves(rank["off"]["grads"]):
            assert torch.equal(got[path], g), (rank["model"], path)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_model_axis_collectives_equal_the_dry_run(model2, setting):
    cfg = model2[0][setting].with_overrides(paged_backend="cuda")
    dry = dryrun.dry_run(cfg, "train", B, S, mesh=(1, 1, 2))
    assert dry["remat"] == cfg.remat
    want = _by_axis(dry["collectives"])
    act = B * S * cfg.d_model * 4
    # the attention's and the MLP's sums a layer forward, two of gradients
    # backward but none of the first layer's input (the embedding's), one
    # of the embedding and the unembedding's input; the recomputed
    # forward issues the attention's sum again and stops before the
    # MLP's, whose output no backward reads
    per_layer = 5 if cfg.remat else 4
    assert want[("model", 2, act)] == per_layer * cfg.n_layers + 1
    for rank in model2[1]:
        assert _by_axis(rank[setting]["collectives"]) == want


def test_dry_run_peaks_order_the_settings_on_llama2_7b():
    peaks = {}
    for variant in ("baseline", "remat_dots", "no_remat"):
        cfg = get_config("llama2-7b").with_overrides(
            paged_backend="cuda", **dryrun.VARIANTS[variant])
        res = dryrun.dry_run(cfg, "train", 256, 4096)
        peaks[variant] = res["memory"]["peak_bytes"]
        assert (res["remat"], res["remat_policy"]) == (
            cfg.remat, cfg.remat_policy)
    assert peaks["baseline"] < peaks["remat_dots"] < peaks["no_remat"]


def test_each_period_adds_one_boundary_at_full():
    """llama2-smoke's train step walked at 2, 3 and 4 layers (a period
    each) over 2 × 512 tokens: each period adds its (B, S, d) input, the
    one activation it keeps.  A rank-1 adapter on ``wq`` alone keeps the
    adapter's own per-layer state (gradients, moments, updates) out of
    the way."""
    rows, seq = 2, 512
    base = get_config("llama2-7b", smoke=True).with_overrides(
        paged_backend="cuda", lora_rank=1, lora_targets=("wq",))
    temp = [dryrun.dry_run(base.with_overrides(n_layers=n), "train", rows,
                           seq)["memory"]["temp_bytes"] for n in (2, 3, 4)]
    boundary = rows * seq * base.d_model * 2          # bf16 activations
    for a, b in zip(temp, temp[1:]):
        assert b - a == pytest.approx(boundary, rel=0.05)


def test_remat_variants_are_accepted(tmp_path):
    for variant, want in (("no_remat", (False, "full")),
                          ("remat_dots", (True, "dots")),
                          ("opt_moe", (True, "dots"))):
        r = dryrun.run_one("dbrx-132b", "train_4k", variant=variant,
                           out_dir=str(tmp_path), smoke=True)
        assert (r["remat"], r["remat_policy"]) == want
    assert dryrun.VARIANTS["opt_moe"] == {"moe_capacity_factor": 1.0,
                                          "remat_policy": "dots"}
    assert not {"no_remat", "remat_dots", "opt_moe"} & set(
        dryrun.XLA_ONLY_VARIANTS)

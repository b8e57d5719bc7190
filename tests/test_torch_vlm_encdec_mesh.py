"""The VLM and the encoder-decoder over a ``("pod", "data", "model")``
mesh against the reference and the port's meshless runs, on
internvl2-smoke and whisper-smoke in fp32 (weights from the reference
init, bridged; adapters, batches, frames, patches and requests
numpy-seeded), each at its own vocabulary of 512, which a model axis of 2
splits, and at 509, which it does not divide (whole on every rank, as
the reference's dry run lays such a vocabulary out), with one spawn of 2
gloo ranks on the CPU for the (1, 1, 2) and (1, 2, 1) meshes (rank
program ``tests/torch_vlm_encdec_ranks.py``, each rank on one torch
thread).

* (a) the rule: ``tensor_parallel.vocab_split`` is true at 512 and false
  at 509; at 509 ``local_config``, ``shard_leaf``, ``local_shard`` and the
  dry run's meta shards keep ``embed`` (and internvl2's ``lm_head``)
  whole; ``join_leaf`` round-trips every leaf bitwise at both; the base
  drawn shard by shard is the whole base's shard;
* (b) at (1, 1, 2), both vocabularies (internvl2 at ``remat`` off and
  "full"; whisper once: the encoder-decoder's forward checkpoints
  nothing, as the reference's): the LoRA
  loss and every gradient leaf, gathered over the model ranks, against
  ``jax.value_and_grad`` of the reference's loss (internvl2 with patch
  embeddings; a whole head that sent its input through the group's
  gradient sum would double the last layers' gradients); whisper's
  ``cross_attn.wv`` gradient exactly 0 on both ranks; an SGD step whose
  clip binds against the meshless step;
* (c) one FDLoRA round at (1, 1, 2) (both vocabularies) and (1, 2, 1)
  against the meshless round, by ``tests/test_torch_moe_mesh.py``'s rules;
* (d) whisper at (1, 1, 2), both vocabularies: ``prefill_cross`` then 8
  greedy ``decode_step`` calls, the streams equal to the reference's
  greedy ``decode_step`` streams, the ranks' cross K/V (each its kv
  heads) joined against the meshless cache;
* (e) internvl2 ``ServeConfig.mesh`` at (1, 1, 2) and (1, 2, 1) with
  ``num_shards`` 2 at 509: greedy streams equal the reference engine's,
  a sampled stream at (1, 1, 2) equals the port's meshless sampled
  stream;
* (f) each rank's collective log equal to the dry run's ``train``,
  ``prefill``, ``decode`` and ``fdlora_round`` walks at the same mesh, at
  both vocabularies; where the vocabulary is whole, no collective touches
  it.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_vlm_encdec_ranks as R
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
from repro_torch.core.lora import adapter_specs, lora_scale, tree_leaves
from repro_torch.core.partition import P
from repro_torch.federated import distributed
from repro_torch.federated.mesh_job import Case, RoundJob, run
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models import encdec
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.serving.engine import ServeConfig
from repro_torch.training.optimizers import sgd
from repro_torch.training.train_step import make_lora_train_step
from test_torch_moe_mesh import REL_TOL, ROUND_TOL, _by_axis, _equal
from test_torch_moe_mesh import _leaves_close
from test_torch_ssm_mesh import _gather
from test_torch_tensor_parallel import GRAD_TOL, LOSS_TOL

ARCHS = {"internvl2-smoke": "internvl2-26b", "whisper-smoke": "whisper-small"}
VOCABS = {"split": 512, "whole": 509}
MESHES = {"1x1x2": (1, 1, 2), "1x2x1": (1, 2, 1)}
B, S = 4, 16
N, K = 2, 1                 # the round's clients and inner steps
INNER_LR, OUTER_LR, MOMENTUM = 1e-3, 0.5, 0.5
SGD_LR, CLIP = 0.5, 0.05
STEPS = 8                   # whisper's greedy decode steps
SERVE = dict(batch_size=4, max_new_tokens=6, block_size=4, prefill_chunk=8,
             num_shards=2)
SAMPLED = dict(SERVE, temperature=0.8, seed=3)
WV = "['dec_blocks']['cross_attn']['wv']"
# the train step's (arch, remat) cases: whisper once, since the
# encoder-decoder's forward checkpoints nothing (as the reference's)
STEP_CASES = [("internvl2-smoke", False), ("internvl2-smoke", True),
              ("whisper-smoke", False)]
STEP_IDS = ["internvl2-remat-off", "internvl2-remat-full", "whisper"]
# the rounds' (mesh, vocabulary) cases: data 2 splits no vocabulary
ROUNDS = [("1x1x2", "split"), ("1x1x2", "whole"), ("1x2x1", "whole")]
ROUND_IDS = [f"{m}-{v}" for m, v in ROUNDS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name, vocab):
    return j_get_config(ARCHS[name], smoke=True).with_overrides(
        dtype="float32", param_dtype="float32", vocab_size=VOCABS[vocab])


def _pcfg(name, vocab):
    return bridge.config_from_jax(_jcfg(name, vocab))


_SETUPS = {}


def _setup(name, vocab):
    """(jcfg, jax model, jax params, port cfg, port params), fp32, the
    smoke configs' remat, built once: the whole vocabulary's weights are
    the split one's without its last 3 entries (``embed`` rows, an untied
    ``lm_head``'s columns)."""
    if (name, vocab) not in _SETUPS:
        jcfg = _jcfg(name, vocab)
        jm = get_model(jcfg)
        if vocab == "split":
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        else:
            V = jcfg.vocab_size
            jp = dict(_setup(name, "split")[2])
            jp["embed"] = jp["embed"][:V]
            if "lm_head" in jp:
                jp["lm_head"] = jp["lm_head"][:, :V]
        _SETUPS[name, vocab] = (
            jcfg, jm, jp, bridge.config_from_jax(jcfg),
            bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"))
    return _SETUPS[name, vocab]


def _tree(jcfg, seed):
    """A numpy-seeded adapter tree in the reference's layout (B non-zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        j_init_adapters(jax.random.PRNGKey(0), jcfg))


def _batch(jcfg, seed, lead=(B,)):
    """Tokens, a loss mask and the family's stub embeddings (numpy), with
    ``lead`` leading dims ((N, K, B) for a round)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (*lead, S))
           .astype(np.int32),
           "loss_mask": (rng.random((*lead, S)) < 0.7).astype(np.int32)}
    if jcfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (*lead, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    else:
        out["enc_embeds"] = rng.standard_normal(
            (*lead, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _requests(vocab):
    """6 ragged requests over 4 clients and 4 slots (prompts of 5 to 24
    tokens, 3 to 6 new), text only."""
    rng = np.random.default_rng(11)
    return [(f"c{i % 4}", rng.integers(0, vocab, int(rng.integers(5, 25)))
             .astype(np.int32), int(rng.integers(3, 7))) for i in range(6)]


def _clients(jcfg):
    return {f"c{i}": _tree(jcfg, 20 + i) for i in range(4)}


# ---------------------------------------------------------------------------
# (a) the rule
# ---------------------------------------------------------------------------

def _vocab_leaves(name):
    return ("embed",) + (("lm_head",) if name == "internvl2-smoke" else ())


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("name", list(ARCHS))
def test_a_vocabulary_the_axis_does_not_divide_stays_whole(name, vocab):
    cfg = _pcfg(name, vocab)
    split = vocab == "split"
    assert tpl.vocab_split(cfg, 2) is split
    V = cfg.vocab_size
    assert tpl.local_config(cfg, 2).vocab_size == (V // 2 if split else V)
    model = Model(cfg, "cpu")
    params, specs = model.init(3), model.param_specs()
    per = V // 2 if split else V
    for r in (0, 1):
        mesh = dryrun.RankMesh((1, 1, 2))
        mesh.get_coordinate = lambda r=r: (0, 0, r)
        local = distributed.local_shard(params, specs, mesh)
        drawn = model.init(3, shard=(2, r))
        meta, _ = dryrun._params_adapters(Model(cfg, "meta"), cfg, mesh)
        for k in _vocab_leaves(name):
            dim = 0 if k == "embed" else 1
            cut = tpl.shard_leaf(params[k], specs[k], 2, r)
            for t in (cut, local[k], drawn[k], meta[k]):
                assert t.shape[dim] == per, k
            if not split:
                assert cut is params[k] and torch.equal(local[k], params[k])
        for (p, g), (_, w) in zip(tree_leaves(drawn), tree_leaves(local)):
            assert torch.equal(g, w), p
    # every leaf round-trips through the cut and the join
    for (p, t), (_, spec) in zip(tree_leaves(params), tree_leaves(specs)):
        parts = [tpl.shard_leaf(t, spec, 2, r) for r in (0, 1)]
        assert torch.equal(tpl.join_leaf(spec, parts), t), p


def test_a_vocabulary_that_divides_is_never_kept_whole_and_others_refuse():
    """``local_shard`` still refuses any other dim the axis does not
    divide; the heads that do not divide still refuse by name."""
    spec = P(None, "model")
    mesh = dryrun.RankMesh((1, 1, 2))
    with pytest.raises(ValueError, match="does not divide"):
        distributed.local_shard({"w": torch.zeros(4, 509)}, {"w": spec},
                                mesh)
    with pytest.raises(ValueError, match="n_heads 4 does not divide"):
        tpl.check_model_axis(_pcfg("whisper-smoke", "whole"), 8)
    whole = tpl.Vocab("model", 509)
    assert whole == "model" and not tpl.vocab_split(whole, 2)
    assert tpl.vocab_split(tpl.Vocab("model", 512), 2)


# ---------------------------------------------------------------------------
# the jobs and the spawn
# ---------------------------------------------------------------------------

def _step_job(name, vocab, remat):
    jcfg, _, _, pcfg, pp = _setup(name, vocab)
    return {"kind": "step", "mesh": (1, 1, 2),
            "cfg": pcfg.with_overrides(remat=remat, remat_policy="full"),
            "params": pp,
            "adapters": bridge.adapters_from_jax(_tree(jcfg, 1), "cpu"),
            "batch": _torch(_batch(jcfg, 2)), "lr": SGD_LR, "clip": CLIP}


def _round_job(name, vocab, mesh):
    jcfg, _, _, pcfg, pp = _setup(name, vocab)
    case = (Case(None, sync=True) if mesh is None else
            Case(pod=mesh[0], data=mesh[1], model=mesh[2], sync=True))
    return RoundJob(pcfg, [case], clients=N, inner_steps=K, rows=B, seq=S,
                    rounds=1, inner_lr=INNER_LR, outer_lr=OUTER_LR,
                    outer_momentum=MOMENTUM, params=pp,
                    theta=bridge.adapters_from_jax(_tree(jcfg, 3), "cpu"),
                    batches=[_batch(jcfg, 5, (N, K, B))], device="cpu")


def _decode_inputs(jcfg):
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((B, jcfg.encoder_seq_len, jcfg.d_model)
                              ).astype(np.float32)
    first = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    return enc, first


def _decode_job(vocab):
    jcfg, _, _, pcfg, pp = _setup("whisper-smoke", vocab)
    enc, first = _decode_inputs(jcfg)
    return {"kind": "decode", "mesh": (1, 1, 2), "cfg": pcfg, "params": pp,
            "adapters": bridge.adapters_from_jax(_tree(jcfg, 4), "cpu"),
            "enc": torch.from_numpy(enc), "first": torch.from_numpy(first),
            "steps": STEPS}


def _serve_job(mesh, runs):
    jcfg, _, _, pcfg, pp = _setup("internvl2-smoke", "whole")
    reqs = _requests(jcfg.vocab_size)
    return {"kind": "serve", "mesh": mesh, "params": pp,
            "clients": {c: bridge.adapters_from_jax(t, "cpu")
                        for c, t in _clients(jcfg).items()},
            "runs": [(pcfg, reqs, kw) for kw in runs]}


def _jobs():
    jobs, keys = [], []
    for name, remat in STEP_CASES:
        for vocab in VOCABS:
            jobs.append(_step_job(name, vocab, remat))
            keys.append(("step", name, vocab, remat))
    for name in ARCHS:
        for mname, vocab in ROUNDS:
            jobs.append({"kind": "round", "mesh": MESHES[mname],
                         "round": _round_job(name, vocab, MESHES[mname])})
            keys.append(("round", name, mname, vocab))
    for vocab in VOCABS:
        jobs.append(_decode_job(vocab))
        keys.append(("decode", vocab))
    jobs.append(_serve_job((1, 1, 2), [SERVE, SAMPLED]))
    keys.append(("serve", "1x1x2"))
    jobs.append(_serve_job((1, 2, 1), [SERVE]))
    keys.append(("serve", "1x2x1"))
    jobs.append({"kind": "walks", "mesh": (1, 1, 2), "walks": _walk_list()})
    keys.append(("walks",))
    return jobs, keys


def _walk_list():
    """The dry run's walks (key, cfg, step, rows, seq, mesh, options):
    per arch and vocabulary the train step at (1, 1, 2) (``STEP_CASES``)
    and the rounds (``ROUNDS``); whisper's prefill (a
    forward over the decode
    job's first tokens) and decode step; internvl2's text-only serving
    (a VLM forward with no patch tokens) prefill chunk and decode step of
    ``SERVE``'s slots at both meshes."""
    out = []
    K_, T = SERVE["batch_size"], SERVE["prefill_chunk"]
    paged = {"block_size": SERVE["block_size"]}
    for name in ARCHS:
        for vocab in VOCABS:
            pcfg = _pcfg(name, vocab).with_overrides(paged_backend="cuda",
                                                     remat_policy="full")
            for remat in (r for n, r in STEP_CASES if n == name):
                out.append(((name, vocab, "train", remat),
                            pcfg.with_overrides(remat=remat), "train", B, S,
                            (1, 1, 2), {}))
            for mname in (m for m, v in ROUNDS if v == vocab):
                out.append(((name, vocab, "round", mname), pcfg,
                            "fdlora_round", N * B, S, MESHES[mname],
                            {"n_clients": N, "K": K}))
            if name == "whisper-smoke":
                out += [((name, vocab, "prefill"), pcfg, "prefill", B, 1,
                         (1, 1, 2), {}),
                        ((name, vocab, "decode"), pcfg, "decode", B, STEPS,
                         (1, 1, 2), {})]
    text = _pcfg("internvl2-smoke", "whole").with_overrides(
        paged_backend="cuda", n_patch_tokens=0)
    for mname, mesh in MESHES.items():
        out += [(("serve", mname, "prefill"), text, "prefill", K_, T, mesh,
                 paged),
                (("serve", mname, "decode"), text, "decode", K_, 16, mesh,
                 paged)]
    return out


@pytest.fixture(scope="module")
def ranks():
    """Every job's results, keyed by kind and case: one per rank, in rank
    order; the dry run's walks, which the ranks make last.  They run
    while this process computes the references."""
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
            for vocab in VOCABS:
                _step_reference(name, vocab)
                _round_meshless(name, vocab)
        for vocab in VOCABS:
            _decode_reference(vocab)
        _serve_reference()
    finally:
        t.join()
    if "err" in got:
        raise got["err"]
    for rk in got["out"]:
        _WALKS.update({k: _by_axis(v) for k, v in rk[-1]["walks"].items()})
    return {key: [rk[i] for rk in got["out"]] for i, key in enumerate(keys)}


# ---------------------------------------------------------------------------
# (b) the LoRA gradient and a train step at model 2
# ---------------------------------------------------------------------------

_STEP_REF = {}


def _step_reference(name, vocab):
    """The reference's (loss, gradients) at the same adapters and batch,
    port layout, and the port's meshless SGD step."""
    if (name, vocab) not in _STEP_REF:
        jcfg, jm, jp, pcfg, pp = _setup(name, vocab)
        jad = jax.tree.map(jnp.asarray, _tree(jcfg, 1))
        jb = jax.tree.map(jnp.asarray, _batch(jcfg, 2))
        (jl, _), jg = jax.jit(jax.value_and_grad(
            j_ts.make_lora_loss_fn(jm, jcfg), has_aux=True))(jad, jp, jb)
        ad = bridge.adapters_from_jax(_tree(jcfg, 1), "cpu")
        opt = sgd(SGD_LR)
        stepped, _, _ = make_lora_train_step(
            Model(pcfg, "cpu"), pcfg, opt, clip_norm=CLIP)(
                pp, ad, opt.init(ad), _torch(_batch(jcfg, 2)))
        _STEP_REF[name, vocab] = (float(jl), bridge.adapters_from_jax(
            jax.tree.map(np.asarray, jg), "cpu"), stepped, ad)
    return _STEP_REF[name, vocab]


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("name,remat", STEP_CASES, ids=STEP_IDS)
def test_lora_gradient_at_model_2_matches_reference(ranks, name, remat,
                                                    vocab):
    total, grads, _, _ = _step_reference(name, vocab)
    res = ranks["step", name, vocab, remat]
    for r in res:
        assert float(r["own_loss"]) == pytest.approx(total, abs=LOSS_TOL)
    specs = adapter_specs(_setup(name, vocab)[3])
    got = dict(tree_leaves(_gather(specs, res, "grads")))
    want = dict(tree_leaves(grads))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=1e-4, err_msg=path)
    if name == "whisper-smoke":     # never read: exactly 0 on both ranks
        for r in res:
            for p, t in tree_leaves(r["grads"]):
                if p.startswith(WV):
                    assert torch.equal(t, torch.zeros_like(t)), p


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("name,remat", STEP_CASES, ids=STEP_IDS)
def test_a_step_whose_clip_binds_matches_the_meshless_step(ranks, name,
                                                           remat, vocab):
    _, grads, stepped, start = _step_reference(name, vocab)
    norm = float(torch.sqrt(sum(torch.sum(t * t)
                                for _, t in tree_leaves(grads))))
    assert norm > 2 * CLIP
    got = _gather(adapter_specs(_setup(name, vocab)[3]),
                  ranks["step", name, vocab, remat], "stepped")
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


def _round_meshless(name, vocab):
    if (name, vocab) not in _ROUND_REF:
        (_ROUND_REF[name, vocab],) = run(_round_job(name, vocab, None))
    return _ROUND_REF[name, vocab]


@pytest.mark.parametrize("mname,vocab", ROUNDS, ids=ROUND_IDS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_round_matches_the_meshless_round(ranks, name, mname, vocab):
    want = _round_meshless(name, vocab)
    res = [dict(r["rounds"][0], coord=r["coord"])
           for r in ranks["round", name, mname, vocab]]
    for r in res:
        assert r["loss"][0] == pytest.approx(want["loss"][0], rel=REL_TOL)
    jcfg, _, _, pcfg, _ = _setup(name, vocab)
    got = _gather(adapter_specs(pcfg), res, "theta")
    start = bridge.adapters_from_jax(_tree(jcfg, 3), "cpu")
    _leaves_close(got, want["theta"], ROUND_TOL, base=start)


# ---------------------------------------------------------------------------
# (d) whisper's decode at model 2
# ---------------------------------------------------------------------------

_DECODE_REF = {}


def _decode_reference(vocab):
    """The reference's greedy stream (``prefill_cross``, then
    ``decode_step`` fed its own argmax) and the port's meshless cross
    K/V."""
    if vocab not in _DECODE_REF:
        jcfg, jm, jp, pcfg, pp = _setup("whisper-smoke", vocab)
        ad = _tree(jcfg, 4)
        enc, first = _decode_inputs(jcfg)
        scale = lora_scale(pcfg)
        jad = jax.tree.map(jnp.asarray, ad)
        jc = jm.init_decode_cache(B, STEPS)
        jc["cross_k"], jc["cross_v"] = jax.jit(
            lambda p, e, a: j_encdec.prefill_cross(p, e, jcfg, a, scale))(
                jp, jnp.asarray(enc), jad)
        step = jax.jit(lambda p, c, t, n, a: jm.decode_step(
            p, c, t, n, adapters=a, lora_scale=scale))
        tok, toks = jnp.asarray(first), [first]
        for t in range(STEPS):
            lg, jc = step(jp, jc, tok, jnp.int32(t), jad)
            tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
        with torch.no_grad():
            ck, cv = encdec.prefill_cross(
                pp, torch.from_numpy(enc), pcfg,
                bridge.adapters_from_jax(ad, "cpu"), scale)
        _DECODE_REF[vocab] = (np.concatenate(toks, 1), ck, cv)
    return _DECODE_REF[vocab]


@pytest.mark.parametrize("vocab", list(VOCABS))
def test_whisper_decode_at_model_2_matches_the_reference(ranks, vocab):
    want, ck, cv = _decode_reference(vocab)
    res = sorted(ranks["decode", vocab], key=lambda r: r["coord"]["model"])
    pcfg = _setup("whisper-smoke", vocab)[3]
    Kv = pcfg.n_kv_heads // 2
    for r in res:
        np.testing.assert_array_equal(r["tokens"].numpy(), want)
        assert r["vocab_columns"] == (pcfg.vocab_size // 2 if vocab == "split"
                                      else pcfg.vocab_size)
        assert r["cross"][0].shape == (pcfg.n_layers, B,
                                       pcfg.encoder_seq_len, Kv,
                                       pcfg.resolved_head_dim)
    spec = encdec.decode_cache_specs(pcfg)["cross_k"]
    for i, whole in enumerate((ck, cv)):
        joined = tpl.join_leaf(spec, [r["cross"][i] for r in res])
        assert joined.dtype == whole.dtype == torch.bfloat16
        # the encoder's row-parallel partials sum in another order than
        # one product: an element may round to the next bf16 value
        np.testing.assert_allclose(joined.float().numpy(),
                                   whole.float().numpy(), rtol=2 ** -7,
                                   atol=1e-6)
        assert float((joined != whole).float().mean()) < 1e-3


# ---------------------------------------------------------------------------
# (e) internvl2 over ServeConfig.mesh
# ---------------------------------------------------------------------------

_SERVE_REF = {}


def _serve_reference():
    """The reference engine's greedy streams and the port's meshless
    sampled streams, at the whole vocabulary."""
    if not _SERVE_REF:
        jcfg, jm, jp, pcfg, pp = _setup("internvl2-smoke", "whole")
        jreg = JRegistry(jcfg, capacity=4)
        for c, t in _clients(jcfg).items():
            jreg.register(c, jax.tree.map(jnp.asarray, t))
        reqs = _requests(jcfg.vocab_size)
        want = JEngine(jm, jcfg, jp, jreg).generate(
            [JRequest(c, p, max_new_tokens=b) for c, p, b in reqs],
            JServeConfig(**SERVE))
        job = _serve_job(None, [])
        eng = R.MR.SR.build_engine(pcfg, pp, job["clients"], 4)
        sampled = eng.generate(R.MR.SR.requests(reqs),
                               ServeConfig(**SAMPLED))
        _SERVE_REF.update(greedy=[np.asarray(o) for o in want],
                          sampled=sampled)
    return _SERVE_REF


@pytest.mark.parametrize("mname", list(MESHES))
def test_internvl2_greedy_streams_equal_the_reference_engine(ranks, mname):
    want = _serve_reference()["greedy"]
    for r in ranks["serve", mname]:
        _equal(r["runs"][0]["streams"], want)


def test_internvl2_sampled_stream_at_model_2_equals_the_meshless_one(ranks):
    """The whole logits on every rank, no gather over "model", and the
    meshless stream's (K, V) Exp(1) draws."""
    want = _serve_reference()["sampled"]
    for r in ranks["serve", "1x1x2"]:
        _equal(r["runs"][1]["streams"], want)
        assert not any(c["axis"] == "model" and c["op"] == "all-gather"
                       for c in r["runs"][1]["collectives"])


# ---------------------------------------------------------------------------
# (f) the collectives against the dry run's walks
# ---------------------------------------------------------------------------

_WALKS = {}     # the ranks' dry-run walks: key -> {(axis, group, bytes): n}


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("name,remat", STEP_CASES, ids=STEP_IDS)
def test_train_collectives_equal_the_dry_run(ranks, name, remat, vocab):
    want = _WALKS[name, vocab, "train", remat]
    for r in ranks["step", name, vocab, remat]:
        assert _by_axis(r["collectives"]) == want


@pytest.mark.parametrize("name,remat", STEP_CASES, ids=STEP_IDS)
def test_a_whole_vocabulary_drops_the_vocabulary_collectives(ranks, name,
                                                             remat):
    """The train walk at the whole vocabulary issues five fewer: the
    embedding's sum, the head's input's backward sum, and the loss's max,
    (2, B, S - 1) sum and argmax; the decode and prefill walks two fewer
    (the embedding's sum, the greedy sample's reduce)."""
    split, whole = (_WALKS[name, v, "train", remat] for v in VOCABS)
    assert sum(split.values()) - sum(whole.values()) == 5
    loss = {B * (S - 1) * 4, 2 * B * (S - 1) * 4}
    assert not any(nb in loss for _, _, nb in whole)
    assert sum(n for (_, _, nb), n in split.items() if nb in loss) == 3
    if name == "whisper-smoke":
        for step in ("prefill", "decode"):
            split, whole = (_WALKS[name, v, step] for v in VOCABS)
            assert sum(split.values()) - sum(whole.values()) == 2


@pytest.mark.parametrize("mname,vocab", ROUNDS, ids=ROUND_IDS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_round_collectives_equal_the_dry_run(ranks, name, mname, vocab):
    want = _WALKS[name, vocab, "round", mname]
    for r in ranks["round", name, mname, vocab]:
        (log,) = r["rounds"][0]["collectives"]
        assert _by_axis(log) == want


@pytest.mark.parametrize("vocab", list(VOCABS))
def test_whisper_decode_collectives_equal_the_dry_run(ranks, vocab):
    """Each step's log is the decode walk's (the step, then the greedy
    sample: one reduce over "model" where the vocabulary is split, none
    where it is whole); ``prefill_cross`` sums each encoder layer's two
    (B, T, d) partials."""
    pcfg = _setup("whisper-smoke", vocab)[3]
    want = _WALKS["whisper-smoke", vocab, "decode"]
    act = B * pcfg.encoder_seq_len * pcfg.d_model * 4
    for r in ranks["decode", vocab]:
        assert len(r["step_collectives"]) == STEPS
        for log in r["step_collectives"]:
            assert _by_axis(log) == want
        assert _by_axis(r["prefill_collectives"]) == {
            ("model", 2, act): 2 * pcfg.n_encoder_layers}
        assert (_by_axis(r["forward_collectives"])
                == _WALKS["whisper-smoke", vocab, "prefill"])
    samples = sum(n for (a, _, nb), n in want.items()
                  if a == "model" and nb == 2 * B * 2 * 4)
    assert samples == (1 if vocab == "split" else 0)


@pytest.mark.parametrize("mname", list(MESHES))
def test_internvl2_serve_collectives_equal_the_dry_run(ranks, mname):
    walks = {k: _WALKS["serve", mname, k] for k in ("prefill", "decode")}
    for r in ranks["serve", mname]:
        for run_ in r["runs"]:
            st, want = run_["stats"], {}
            for s, n in (("prefill", st["prefill_dispatches"]),
                         ("decode", st["decode_steps"])):
                for key, c in walks[s].items():
                    want[key] = want.get(key, 0) + n * c
            assert _by_axis(run_["collectives"]) == want

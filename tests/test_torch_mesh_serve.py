"""Serving over a ``("pod", "data", "model")`` mesh (``ServeConfig.mesh``)
against the reference and the port's meshless engine, on ``tiny_dense`` in
fp32 (4 heads, 2 kv heads, d_ff 128 and vocabulary 300, each divisible by
2), with gloo ranks on the CPU (rank program ``tests/torch_serve_ranks.py``,
one spawn of 2 ranks and one of 4, each rank on one torch thread).

* greedy streams at (1, 2, 1) with ``num_shards`` 2, at (1, 1, 2) and at
  (1, 2, 2) equal, token for token, the JAX package's meshless
  ``MultiTenantEngine.generate`` on the same weights, adapters and
  requests, and the port's meshless streams bitwise;
* sampled streams (temperature 0.8) at (1, 2, 1) bitwise the port's
  meshless stream at the same shard count: a token's draw is its slot's
  row of the stream's (K, V) Exp(1) noise, so the comparison keeps the
  placement (2 shards place requests on other slots than one pool);
* at (1, 1, 2) the prefill chunk's and a decode step's fp32 logits,
  gathered over the model ranks, within ``LOGIT_TOL`` of the reference's
  ``prefill_step`` and ``decode_step``;
* int8 K/V pools over a ragged int8 bank: a warm prefix-cached stream
  equals the cold one, and both the meshless one, at each mesh;
  speculative decoding equals sequential greedy decoding under one mesh;
* the ranks' collective log equals the dry run's ``prefill`` and
  ``decode`` walks at the same mesh, dispatch by dispatch, and the dry
  run's per-rank argument bytes are the local shards';
* the bank's model shard (ragged, int8, kernel view), a data rank's block
  tables, the one-reduce vocabulary-parallel argmax with ties across
  blocks, and the refusals: an expert count that does not divide at
  "model" > 1 (the SSM and hybrid archs and the VLM accepted there and at
  "data" > 1; the encoder-decoder refused by the meshless engine's own
  check, not by the mesh), ``num_shards`` not a multiple of "data", the
  open-loop front ends and the fixed-batch path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_ranks as R
from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import init_adapters, tree_leaves
from repro_torch.federated.distributed import local_shard
from repro_torch.kernels.ops import concat_buckets
from repro_torch.launch import dryrun, serve
from repro_torch.launch.mesh import spawn
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from repro_torch.serving.engine import ServeConfig, check_serve_mesh
from repro_torch.serving.registry import AdapterRegistry, model_shard
from repro_torch.serving.sharded import ShardedPagedKVCache
from repro_torch.serving.trace import run_trace, synth_trace
from test_torch_tensor_parallel import ThreadGroup

VOCAB = 300
LOGIT_TOL = 1e-4           # fp32, as tests/test_torch_model.py
BASE = dict(batch_size=4, max_new_tokens=6, block_size=4, num_blocks=25,
            prefill_chunk=4)
TEMP = dict(temperature=0.8, seed=3)
INT8 = dict(kv_dtype="int8", prefix_cache=True)
RAGGED = {"ranks": [2, 4], "bank_dtype": "int8"}
MESHES = {"1x2x1": (1, 2, 1), "1x1x2": (1, 1, 2), "1x2x2": (1, 2, 2)}
SHARDS = {"1x2x1": 2, "1x1x2": 1, "1x2x2": 2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jcfg, seed, rank=None):
    """A numpy-seeded adapter tree in the reference's layout (B non-zero)."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def _requests():
    """8 ragged requests over 4 clients and 4 slots; c0's and c2's first
    prompts share a 10-token prefix, so a warm pool hits, and the second
    and sixth repeat a trigram, so the drafter proposes."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, VOCAB, 10).astype(np.int32)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(2, 13))
        p = rng.integers(0, VOCAB, plen).astype(np.int32)
        if i in (0, 2, 4):
            p = np.concatenate([shared, p[:2]])
        if i in (1, 5):
            p = np.tile(p[:3], 4)
        reqs.append((f"c{i % 4}", p, int(rng.integers(6, 13))))
    return reqs


@pytest.fixture(scope="module")
def base():
    """The reference's tiny model and 4 clients' trees (bridged), the
    ragged clients (ranks 2 and 4), the requests, and the JAX engine's
    meshless greedy streams."""
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jtrees = {f"c{i}": _tree(jcfg, 20 + i) for i in range(4)}
    clients = {c: bridge.adapters_from_jax(t, device="cpu")
               for c, t in jtrees.items()}
    ragged = {f"c{i}": bridge.adapters_from_jax(
        _tree(jcfg, 30 + i, RAGGED["ranks"][i % 2]), device="cpu")
        for i in range(4)}
    jreg = JRegistry(jcfg, capacity=4)
    for c, t in jtrees.items():
        jreg.register(c, jax.tree.map(jnp.asarray, t))
    reqs = _requests()
    jeng = JEngine(jm, jcfg, jp, jreg)
    want = jeng.generate([JRequest(c, p, max_new_tokens=b)
                          for c, p, b in reqs],
                         JServeConfig(**BASE, num_shards=2))
    return {"jcfg": jcfg, "jm": jm, "jp": jp, "jreg": jreg, "cfg": pcfg,
            "params": pp, "clients": clients, "ragged": ragged,
            "reqs": reqs, "jax": [np.asarray(w) for w in want]}


def _job(base, mesh, runs, ragged=False, logits=None):
    job = {"mesh": mesh, "cfg": base["cfg"], "params": base["params"],
           "clients": base["ragged" if ragged else "clients"],
           "capacity": 8 if ragged else 4, "runs": runs}
    if ragged:
        job["registry_kw"] = RAGGED
    if logits is not None:
        job["logits"] = logits
    return job


def _logit_reqs(base):
    return [(c, p, b) for c, p, b in base["reqs"][:4]]


def _runs(base, name):
    """Per mesh: (job name, ragged, runs) in the order the ranks run
    them."""
    reqs, shards = base["reqs"], SHARDS[name]
    plain = [(reqs, dict(BASE, num_shards=shards)),
             (reqs, dict(BASE, num_shards=shards, spec_decode=True))]
    if name == "1x2x1":
        plain.append((reqs, dict(BASE, num_shards=shards, **TEMP)))
    int8 = [(reqs, dict(BASE, num_shards=shards, **INT8))] * 2
    return [("plain", False, plain), ("int8", True, int8)]


def _world_jobs(base, names):
    jobs, keys = [], []
    for name in names:
        for kind, ragged, runs in _runs(base, name):
            logits = None
            if name == "1x1x2" and kind == "plain":
                logits = (_logit_reqs(base), BASE,
                          np.arange(4, dtype=np.int32) * 7)
            jobs.append(_job(base, MESHES[name], runs, ragged, logits))
            keys.append((name, kind))
    return jobs, keys


def _spawn(base, world, names):
    jobs, keys = _world_jobs(base, names)
    ranks = spawn(R.serve_jobs, world, jobs, device="cpu")
    return {key: [rk[i] for rk in ranks] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def served(base):
    """Every mesh's jobs, keyed (mesh name, "plain" | "int8"): one result
    per rank.  One spawn of 2 ranks, one of 4."""
    out = _spawn(base, 2, ["1x2x1", "1x1x2"])
    out.update(_spawn(base, 4, ["1x2x2"]))
    return out


@pytest.fixture(scope="module")
def meshless(base):
    """The port's meshless streams of every run, keyed (mesh name, kind)."""
    out = {}
    engines = {False: R.build_engine(base["cfg"], base["params"],
                                     base["clients"], 4),
               True: R.build_engine(base["cfg"], base["params"],
                                    base["ragged"], 8, RAGGED)}
    for name in MESHES:
        for kind, ragged, runs in _runs(base, name):
            eng = engines[ragged]
            eng.release_prefix_cache()
            out[name, kind] = [eng.generate(R.requests(reqs),
                                            ServeConfig(**kw))
                               for reqs, kw in runs]
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_greedy_streams_equal_the_reference(base, served, meshless, name):
    ranks = served[name, "plain"]
    assert len(ranks) == np.prod(MESHES[name])
    for rk in ranks:
        run = rk["runs"][0]
        _equal(run["streams"], base["jax"])
        _equal(run["streams"], meshless[name, "plain"][0])
        assert run["stats"]["mesh"] == dict(zip(("pod", "data", "model"),
                                                MESHES[name]))
        assert run["stats"]["num_shards"] == SHARDS[name]


@pytest.mark.parametrize("name", ["1x2x1", "1x1x2"])
def test_spec_decode_equals_sequential_under_the_mesh(base, served, name):
    for rk in served[name, "plain"]:
        plain, spec = rk["runs"][0], rk["runs"][1]
        _equal(spec["streams"], plain["streams"])
        assert spec["stats"]["verify_dispatches"] > 0
        assert spec["stats"]["accepted_tokens"] >= 0


def test_sampled_streams_at_data_2_are_the_meshless_stream(served,
                                                           meshless):
    want = meshless["1x2x1", "plain"][2]
    for rk in served["1x2x1", "plain"]:
        _equal(rk["runs"][2]["streams"], want)
    greedy = meshless["1x2x1", "plain"][0]
    assert any(not np.array_equal(a, b) for a, b in zip(want, greedy))


@pytest.mark.parametrize("name", list(MESHES))
def test_int8_kv_over_a_ragged_int8_bank_warm_equals_cold(served, meshless,
                                                          name):
    for rk in served[name, "int8"]:
        cold, warm = rk["runs"]
        _equal(warm["streams"], cold["streams"])
        _equal(cold["streams"], meshless[name, "int8"][0])
        assert warm["stats"]["prefix_pool_reused"]
        assert warm["stats"]["prefix_hit_tokens"] > 0
        assert warm["stats"]["kv_dtype"] == "int8"


def test_model_axis_logits_match_reference(base, served):
    """A prefill chunk of four whole prompts and one decode step after it,
    each rank on its heads, ff columns and vocabulary block; the blocks
    concatenated against the reference's steps on the same tables."""
    jm, jp, jcfg = base["jm"], base["jp"], base["jcfg"]
    reqs = _logit_reqs(base)
    tokens, n_new, bt, lens, nb = R.chunk_inputs(reqs, BASE["block_size"])
    ranks = sorted(served["1x1x2", "plain"],
                   key=lambda r: r["coord"]["model"])
    pre = torch.cat([r["logits"][0] for r in ranks], -1).numpy()
    dec = torch.cat([r["logits"][1] for r in ranks], -1).numpy()
    assert [r["logits"][0].shape[-1] for r in ranks] == [150, 150]
    jreg = base["jreg"]
    ids = jnp.asarray([jreg.acquire(c) for c, _, _ in reqs], jnp.int32)
    kw = dict(adapters=jreg.bank(), adapter_ids=ids,
              block_tables=jnp.asarray(bt),
              lora_scale=jcfg.lora_alpha / jcfg.lora_rank)
    jc = jm.init_paged_decode_cache(len(reqs), nb, BASE["block_size"])
    want_pre, jc = jm.prefill_step(jp, jc, jnp.asarray(tokens),
                                   jnp.asarray(lens), jnp.asarray(n_new),
                                   **kw)
    want_dec, _ = jm.decode_step(
        jp, jc, jnp.asarray(np.arange(4, dtype=np.int32) * 7)[:, None],
        jnp.asarray(lens + n_new), **kw)
    valid = np.arange(tokens.shape[1])[None, :] < n_new[:, None]
    np.testing.assert_allclose(pre[valid], np.asarray(want_pre)[valid],
                               atol=LOGIT_TOL, rtol=1e-4)
    np.testing.assert_allclose(dec, np.asarray(want_dec), atol=LOGIT_TOL,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the collective log and the dry run
# ---------------------------------------------------------------------------

def _by_key(log):
    out = {}
    for c in log:
        key = (c["axis"], c["group"], c["bytes"])
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_collective_log_equals_the_dry_run(base, served, name):
    """A stream's collectives are its prefill dispatches' and its decode
    steps', each the dry run's walk of the same step at the same mesh
    (rows: the stream's slots; a prefill chunk's width)."""
    cfg = base["cfg"].with_overrides(paged_backend="cuda")
    mesh = MESHES[name]
    K, T = BASE["batch_size"], BASE["prefill_chunk"]
    walks = {s: _by_key(dryrun.dry_run(cfg, s, K, T if s == "prefill"
                                       else 16, mesh=mesh)["collectives"])
             for s in ("prefill", "decode")}
    for rk in served[name, "plain"]:
        run = rk["runs"][0]
        st = run["stats"]
        want = {}
        for s, n in (("prefill", st["prefill_dispatches"]),
                     ("decode", st["decode_steps"])):
            for key, c in walks[s].items():
                want[key] = want.get(key, 0) + n * c
        assert _by_key(run["collectives"]) == want
    if mesh[2] > 1:       # per layer two sums, the embedding's, the sample's
        assert sum(walks["decode"].values()) == (
            2 * cfg.n_layers + 2 + (mesh[1] > 1))


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_dry_run_argument_bytes_are_the_local_shards(step):
    cfg = bridge.config_from_jax(tiny_dense(
        dtype="float32", param_dtype="float32")).with_overrides(
            paged_backend="cuda")
    B, S = 4, 16
    res = dryrun.dry_run(cfg, step, B, S, mesh=(1, 2, 2))
    mesh = dryrun.RankMesh((1, 2, 2))
    params = local_shard(Model(cfg, "cpu").init(0), param_specs(cfg), mesh)
    local = tpl.local_config(cfg, 2)
    adapters = init_adapters(local, device="cpu")
    rows = B // 2
    inputs = [torch.zeros(rows, S if step == "prefill" else 1,
                          dtype=torch.int32)]
    trees = [params, adapters, inputs]
    if step == "decode":
        inputs.append(torch.zeros((), dtype=torch.int32))
        trees.append(Model(cfg, "cpu").init_decode_cache(
            rows, S, tp=tpl.ModelGroup(2, 0, None)))
    want = sum(t.numel() * t.element_size() for tree in trees
               for _, t in tree_leaves(tree) if isinstance(t, torch.Tensor))
    assert res["memory"]["argument_bytes"] == want
    assert res["roofline"]["chips"] == 4


# ---------------------------------------------------------------------------
# the pieces: the bank's shard, a data rank's tables, the greedy sample
# ---------------------------------------------------------------------------

def test_bank_model_shard_splits_each_factor_and_keeps_the_scales(base):
    cfg = base["cfg"]
    reg = AdapterRegistry(cfg, capacity=8, device="cpu", **RAGGED)
    for c, t in base["ragged"].items():
        reg.register(c, t)
    for view in (reg.bank(), reg.kernel_bank()):
        shards = [model_shard(view, cfg, 2, r) for r in (0, 1)]
        for (path, whole), (_, s0), (_, s1) in zip(
                tree_leaves(view), tree_leaves(shards[0]),
                tree_leaves(shards[1])):
            if s0.shape == whole.shape:        # scales, ranks, unsplit
                assert torch.equal(s0, whole) and torch.equal(s1, whole)
                continue
            d = next(i for i, (a, b) in enumerate(zip(s0.shape, whole.shape))
                     if a != b)
            assert d in (1, 2), path
            assert torch.equal(torch.cat([s0, s1], d), whole), path
    # the kernel view's shard is the shard's kernel view
    layer = model_shard(reg.bank(), cfg, 2, 1)["layers"][0]["mixer"]["wq"]
    got = model_shard(reg.kernel_bank(), cfg, 2, 1)
    for k, v in concat_buckets(layer).items():
        assert torch.equal(v, got["layers"][0]["mixer"]["wq"][k]), k


def test_a_data_ranks_tables_index_its_own_pool():
    """Shards 2 and 3 of 4 on data rank 1 of 2: their slots' rows, their
    block ids shifted into a pool of scratch block 0 and their blocks."""
    kv = ShardedPagedKVCache(4, 8, 4, 1 + 4 * 5, 5)
    for g in range(8):
        s, local = kv.shard_of_slot(g)
        kv.shards[s].admit(local)
        kv.shards[s].ensure(local, 4 + 4 * (g % 3))
    whole, lens = kv.device_tables("cpu")
    mine, mine_lens = kv.device_tables("cpu", range(2, 4))
    assert torch.equal(mine_lens, lens[4:])
    shift = torch.where(whole[4:] > 0, whole[4:] - 2 * 5, whole[4:])
    assert torch.equal(mine, shift)
    assert int(mine.max()) <= 2 * 5 and int(mine[mine > 0].min()) >= 1


@pytest.mark.parametrize("size", [2, 3])
def test_vocab_parallel_greedy_is_the_argmax_in_one_reduce(size):
    rng = np.random.default_rng(size)
    V = 12 * size
    logits = torch.from_numpy(rng.integers(-3, 4, (5, 3, V))
                              .astype(np.float32))
    w = V // size
    logits[0, 0, :] = -5.0
    logits[0, 0, [w * r + 2 for r in range(size)]] = 7.0   # tie over blocks
    calls = []

    def rank(tp):
        calls.append(tp.rank)
        return tpl.vocab_parallel_greedy(
            logits[..., tp.rank * w:(tp.rank + 1) * w], tp)
    out = ThreadGroup(size).run(rank)
    for t in out:
        assert torch.equal(t, torch.argmax(logits, -1))
    assert int(out[0][0, 0]) == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,match", [
    ("dbrx-132b-3-experts", "n_experts 3 does not divide"),
    ("mamba2-2.7b", None),
    ("jamba-v0.1-52b", None), ("internvl2-26b", None),
    ("whisper-small", "decoder-family only")])
def test_families_are_refused_over_the_model_axis(arch, match):
    """A count that does not divide is refused; the SSM and hybrid archs
    and the VLM (``match`` None) are served at model 2 and data 2, the
    VLM text-only as meshless; the encoder-decoder passes the mesh's
    check and is refused by the meshless engine's own, as the reference
    refuses paged decoding of it."""
    cfg = (get_config("dbrx-132b", smoke=True).with_overrides(n_experts=3)
           if arch == "dbrx-132b-3-experts" else get_config(arch, smoke=True))
    if match is None:
        check_serve_mesh(cfg, {"pod": 1, "data": 1, "model": 2})
        check_serve_mesh(cfg, {"pod": 1, "data": 2, "model": 1})
        return
    if cfg.is_encdec:
        check_serve_mesh(cfg, {"pod": 1, "data": 1, "model": 2})
        for shard in (None, (2, 0)):
            with pytest.raises(NotImplementedError, match=match):
                serve.build_engine(cfg, 2, "cpu", shard=shard)
        return
    with pytest.raises(ValueError, match=match):
        check_serve_mesh(cfg, {"pod": 1, "data": 1, "model": 2})


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-2.7b"])
def test_mamba_layers_are_served_over_the_data_axis(arch):
    """A mamba layer's per-slot state is each data rank's slots' rows, so
    the SSM and hybrid archs serve at data 2 (and at data 2 × model 2),
    as the experts do."""
    for cfg in (get_config(arch, smoke=True),
                get_config("dbrx-132b", smoke=True)):
        check_serve_mesh(cfg, {"pod": 1, "data": 2, "model": 1})
        check_serve_mesh(cfg, {"pod": 1, "data": 2, "model": 2})


def test_engine_refuses_what_the_mesh_does_not_serve(base):
    eng = R.build_engine(base["cfg"], base["params"], base["clients"], 4)
    reqs = R.requests(base["reqs"][:2])
    mesh = dryrun.RankMesh((1, 2, 1))
    with pytest.raises(ValueError, match="num_shards 1 is not a multiple "
                                         "of the mesh's \"data\" axis 2"):
        eng.generate(reqs, ServeConfig(**BASE, mesh=mesh))
    sc = ServeConfig(**BASE, num_shards=2, mesh=mesh)
    with pytest.raises(ValueError, match="open-loop.*wall"):
        eng.session(sc)
    with pytest.raises(ValueError, match="open-loop.*wall"):
        run_trace(eng, sc, synth_trace(0, 2))
    with pytest.raises(ValueError, match="fixed-batch path"):
        eng.generate_fixed(reqs, sc)
    # a mesh of size 1 everywhere runs the meshless stream
    one = ServeConfig(**BASE, mesh=dryrun.RankMesh((1, 1, 1)))
    plain = eng.generate(reqs, ServeConfig(**BASE))
    _equal(eng.generate(reqs, one), plain)
    assert dataclasses.replace(one, mesh=None).mesh is None
